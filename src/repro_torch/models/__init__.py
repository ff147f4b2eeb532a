from repro_torch.models import layers, attention, moe, ssm, lm, encdec, resnet
