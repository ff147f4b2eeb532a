"""Small cells for the CPU: ResNet-8 at its published widths on 8x8
images, r = 4, two clients (10 and 22 images at batch 8: a two-step
schedule, one client masked for its second step)."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# limits for these small cells, set from CPU readings on four seeds
# (sound at most: loss_early 1.9e-7, step1_worst and step3_worst 1.0e-5,
# update_median 5.6e-8, wire 0, aggregate 0; the TF32 control at least:
# 4.6e-5, 3.7e-3, 5.9e-3, 5.1e-4)
TINY_LIMITS = {"loss_early": 5e-6, "step1_worst": 5e-4, "step3_worst": 5e-4,
               "update_median": 5e-6, "wire": 0.0, "aggregate": 1e-6}


def tiny_cell(mode: str = "flocora", bits=8) -> dict:
    cfg = json.loads((HERE / "configs" / "resnet8.json").read_text())
    cfg.update(image_size=8, lora_rank=4, lora_alpha=64.0, batch_size=8)
    traffic = {"mode": mode, "quant_bits": bits, "n_clients": 2,
               "clients_per_round": 2, "n_images": 32, "lda_alpha": 1000.0,
               "partition_seed": 0}
    return {"name": "tiny", "chips": 1, "config": cfg, "traffic": traffic,
            "limits": dict(TINY_LIMITS),
            "end_to_end": [{"name": "round_s", "unit": "s"},
                           {"name": "peak_mem_gib", "unit": "GiB"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": []}
