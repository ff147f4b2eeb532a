"""The LM step's sharding vocabulary against the JAX package's:
``utils/pcontext.py`` (a no-op without a callback), the cache logical
trees (``attention.gqa_cache_logical``, ``mla_cache_logical``,
``ssm.mamba_cache_logical``, ``lm.cache_logical`` for every arch and the
enc-dec model's cross-cache annotations, which the reference inlines in
its step builder), ``core.lora.quantize_frozen_logical`` for every arch,
and ``launch.steps.constraint_spec`` / ``make_constrain``: the spec of
every kind on tensors of sharded and indivisible shapes equals the one
the reference's ``make_constrain`` hands to ``with_sharding_constraint``
on meshes (2, 2, 2), (16, 16) and (2, 16, 16), with and without
sequence parallelism; on DTensors over a (2, 2, 2) mesh (torch's
``fake`` backend, world 8) the callback redistributes to the
placements of that spec."""
import contextlib
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro.configs import registry as JR
from repro.core import lora as JLORA
from repro.launch import steps as JS
from repro.models import attention as JA
from repro.models import lm as JLM
from repro.models import ssm as JSSM
from repro_torch.configs import registry as TR
from repro_torch.core import lora as TLORA
from repro_torch.launch import steps as TS
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TED
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TSSM
from repro_torch.utils import pcontext
from repro_torch.utils.sharding import placements

ARCHS = list(JR.REGISTRY)


def test_pcontext_is_a_noop_without_callback():
    x = torch.randn(2, 4, 3)
    for kind in ("residual", "heads", "kv_chunks", "tokens", "expert",
                 "cache4", "cache3", "cache_stack", "anything"):
        assert pcontext.constrain(x, kind) is x
    tree = {"w": x, "b": [x]}
    assert pcontext.params(tree) is tree
    assert pcontext.batch_sum(x) is x
    assert pcontext.token_total(7) == 7
    assert pcontext.expert_split(None, 2, 3) is None
    stack = {"k": torch.randn(3, 2, 5)}
    cache, put_back = pcontext.layer_cache(stack, 1)
    assert cache["k"].data_ptr() == stack["k"][1].data_ptr()
    put_back()
    # a callback applies only inside its block, nested blocks restore
    seen = []
    with pcontext.use(lambda t, k: seen.append(k) or t):
        with pcontext.use(lambda t, k: t * 0):
            assert not pcontext.constrain(x, "heads").any()
        pcontext.constrain(x, "tokens")
    assert seen == ["tokens"] and pcontext.constrain(x, "tokens") is x


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logicals_match_jax(arch):
    entry = TR.get(arch)
    for cfg_j, cfg_t in ((JR.get(arch).smoke(), entry.smoke()),
                         (JR.get(arch).full(), entry.full())):
        if entry.kind == "encdec":
            got = TS.cache_logical(entry, cfg_t)
            want_self = jax.tree.map(
                lambda t: ("layers",) + t, JA.gqa_cache_logical(),
                is_leaf=lambda t: isinstance(t, tuple))
            assert got["self_caches"] == want_self
            assert got["cross_caches"] == {
                "k": ("layers", "batch", "kv_seq", None, None),
                "v": ("layers", "batch", "kv_seq", None, None)}
            continue
        assert TLM.cache_logical(cfg_t) == JLM.cache_logical(cfg_j)
        assert TS.cache_logical(entry, cfg_t) == {
            "caches": JLM.cache_logical(cfg_j)}
        # the annotations fit the caches' ranks
        caches = TLM.cache_init(cfg_t, 2, 16, device="meta")
        for lg, c in zip(TLM.cache_logical(cfg_t), caches):
            for lgl, cl in zip(lg, c):
                assert {k: len(v) for k, v in lgl.items()} == \
                    {k: v.ndim for k, v in cl.items()}
    assert TA.gqa_cache_logical() == JA.gqa_cache_logical()
    assert TA.mla_cache_logical() == JA.mla_cache_logical()
    assert TSSM.mamba_cache_logical() == JSSM.mamba_cache_logical()


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_frozen_logical_matches_jax(arch):
    entry = TR.get(arch)
    mod_t = TED if entry.kind == "encdec" else TLM
    from repro.models import encdec as JED
    mod_j = JED if entry.kind == "encdec" else JLM
    got = TLORA.quantize_frozen_logical(mod_t.logical(entry.smoke())[
        "frozen"])
    want = JLORA.quantize_frozen_logical(mod_j.logical(
        JR.get(arch).smoke())["frozen"])
    assert got == want
    # and it fits the quantized tree, leaf for leaf
    q = TLORA.quantize_frozen_tree(mod_t.init(0, entry.smoke(),
                                              device="meta")["frozen"])

    def walk(lg, t):
        if isinstance(t, torch.Tensor):
            assert len(lg) == t.ndim
            return
        keys = range(len(t)) if isinstance(t, list) else t
        for k in keys:
            walk(lg[k], t[k])
    walk(got, q)


MESHES = [(("pod", "data", "model"), (2, 2, 2)),
          (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
SHAPES = {"residual": [(8, 64, 32), (4, 64, 32), (3, 64, 32), (8, 6, 32)],
          "heads": [(8, 64, 8, 16), (8, 64, 6, 16), (2, 64, 8, 16)],
          "kv_chunks": [(4, 8, 16, 8, 32), (4, 2, 16, 8, 32),
                        (4, 8, 16, 3, 32)],
          "tokens": [(256, 32), (16, 32), (6, 32), (4096, 32)],
          "expert": [(16, 64, 32), (4, 64, 32), (16, 3, 32)],
          "cache4": [(8, 128, 2, 16), (1, 128, 2, 16), (3, 5, 2, 16)],
          "cache3": [(8, 128, 16), (1, 128, 16), (3, 5, 16)],
          "cache_stack": [(4, 8, 128, 2, 16), (4, 1, 128, 16),
                          (4, 3, 5, 16), (4, 8, 16, 4, 8, 16)]}


@contextlib.contextmanager
def _jax_specs():
    """While open, the reference's ``make_constrain`` returns the spec it
    would hand to ``with_sharding_constraint``."""
    saved = (JS.NamedSharding, jax.lax.with_sharding_constraint)
    JS.NamedSharding = lambda mesh, spec: spec
    jax.lax.with_sharding_constraint = lambda x, spec: ("spec", spec)
    try:
        yield
    finally:
        JS.NamedSharding, jax.lax.with_sharding_constraint = saved


@pytest.mark.parametrize("names,shape", MESHES)
@pytest.mark.parametrize("sp", [False, True])
def test_constraint_specs_match_jax(names, shape, sp):
    jmesh = types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(shape, np.int8))
    tmesh = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    jplan, tplan = JS.CellPlan(seq_parallel=sp), TS.CellPlan(seq_parallel=sp)
    with _jax_specs():
        jc = JS.make_constrain(jmesh, jplan)
        n = 0
        for kind, shapes in SHAPES.items():
            for s in shapes:
                out = jc(np.empty(s, np.int8), kind)
                want = tuple(out[1]) if isinstance(out, tuple) else None
                got = TS.constraint_spec(tmesh, tplan, s, kind)
                assert got == want, (kind, s, got, want)
                n += want is not None
    assert n >= 10        # most cases shard something


@contextlib.contextmanager
def fake_world(world: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_constrain_redistributes_dtensors():
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        for sp in (False, True):
            plan = TS.CellPlan(seq_parallel=sp)
            c = TS.make_constrain(mesh, plan)
            for kind, shapes in SHAPES.items():
                for s in shapes:
                    x = distribute_tensor(torch.zeros(s), mesh,
                                          [Replicate()] * 3)
                    y = c(x, kind)
                    spec = TS.constraint_spec(mesh, plan, s, kind)
                    assert isinstance(y, DTensor)
                    want = tuple(placements(spec, mesh)) if spec else \
                        (Replicate(),) * 3
                    assert tuple(y.placements) == want, (kind, s)
            # a local tensor is left alone
            z = torch.zeros(8, 64, 32)
            assert c(z, "residual") is z
