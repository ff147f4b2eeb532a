from repro_torch.models import layers, resnet
