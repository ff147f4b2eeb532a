from repro_torch.fl.client import ClientConfig, make_cohort_trainer, \
    make_local_trainer, make_staggered_cohort_trainer, \
    stack_local_batches, stack_cohort_batches, pad_cohort_batches, pow2_pad
from repro_torch.fl.server import ServerConfig, FLServer, WireAccounting
