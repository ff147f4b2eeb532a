from repro_torch.configs.registry import REGISTRY, SHAPES, ArchEntry, get, \
    cells
