"""Elastic scaling: restore a logical checkpoint onto a DIFFERENT mesh.

Checkpoints store unsharded host arrays (``repro_torch.checkpoint``, the
JAX package's format); a restarted job builds its own mesh (any shape
whose axes divide the dims per the best-effort rules) and distributes
every leaf with the DTensor placements derived from the same logical
annotations (``utils/sharding.py``): ``restore(..., shardings=)``, in
which each rank reads the file and keeps only its block. Nothing about
the checkpoint depends on the old topology: scale 256 -> 512 cards, or
down to one, without conversion; a checkpoint written by either
package restores here."""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.checkpoint import latest_step, restore
from repro_torch.utils.sharding import tree_shardings


def elastic_restore(directory: str, like: dict[str, Any],
                    logical: dict[str, Any], mesh=None,
                    rules: Optional[dict] = None,
                    step: Optional[int] = None):
    """like/logical: {'group': tree} / {'group': logical-annotation tree}.
    Groups present in ``logical`` come back as DTensors on ``mesh``
    (default: ``launch.mesh.make_host_mesh()`` on the card), each leaf
    with the placements of its annotation; other groups land on the
    host. Returns (step, trees, manifest), or None without a complete
    checkpoint."""
    if mesh is None:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh()
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    shardings = {g: (mesh, tree_shardings(logical[g], like[g], mesh, rules))
                 for g in logical}
    trees, man = restore(directory, step, like, shardings, device="cpu")
    return step, trees, man
