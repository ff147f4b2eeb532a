from repro_torch.fl.client import ClientConfig, make_cohort_trainer, \
    make_local_trainer, make_staggered_cohort_trainer, \
    stack_local_batches, stack_cohort_batches, pad_cohort_batches, pow2_pad
from repro_torch.fl.server import ServerConfig, FLServer, WireAccounting
from repro_torch.fl.async_engine import AsyncConfig, AsyncFLServer, \
    time_to_target
from repro_torch.fl.traces import AvailabilityWindows, FleetTrace, \
    LognormalLatency
from repro_torch.fl.population import DeviceTier, Population, \
    PopulationTrace, default_tiers
