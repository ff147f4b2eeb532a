from repro_torch.data.synthetic import SyntheticVision
from repro_torch.data.partition import lda_partition
