from repro_torch.data.synthetic import SyntheticVision, client_shard, \
    linear_shard, markov_lm_batch, synthetic_lm_batch
from repro_torch.data.partition import lda_partition
