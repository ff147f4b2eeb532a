from repro_torch.optim.optimizers import Optimizer, sgd, adamw, \
    clip_by_global_norm
from repro_torch.optim.schedule import constant, cosine_warmup
