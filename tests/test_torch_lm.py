"""The port's decoder LM (``repro_torch.models.lm``) against the JAX
package's, on JAX ``LM.init`` trees carried across by ``convert``: the
smoke configs of gemma3-4b, minitron-4b, qwen1.5-110b and
nemotron-4-340b, of the MLA and MoE archs deepseek-v2-236b and
llama4-maverick-400b-a17b and of the Mamba-2 archs mamba2-370m and
zamba2-2.7b, and the GQA, padded-head, sliding-window-ring, MLA, Mamba
and zamba configs of tests/test_consistency.py. The adapters' ``b``
factors are moved off their zero init, so every adapter gets a gradient.

Routes. A MoE layer routes each token by its fp32 router over a bf16
input. The two packages' residual streams part by bf16 ulps, so at a
near tie a token goes to another expert in one package than in the
other, and its output then differs by a whole expert's contribution
(deepseek-v2's smoke config: MoE layer 1, batch row 0, token 15 picks
experts (6, 7) in the JAX package and (6, 3) in the port; experts 3 and
7 have probabilities 0.1760 / 0.1797 there and 0.1788 / 0.1780 here).
So the MoE checks run the port on TEACHER-FORCED routes
(``RouteOracle``): each routing call records the port's own top-k, then
takes the JAX package's top-k for the same call (recorded through a
``jax.debug.callback`` beside the reference's router) with the port's
own gates at those experts. Every call's own routes are held to the
JAX ones: equal, or a near tie, where the expert the JAX package picked
has a probability within ``ROUTE_TIE`` (relative) of the one the port
picked. The forward check prints the agreement layer by layer.

Tolerances. Both packages run the residual stream, the linears and the
logits in bf16. The reference's XLA programs may keep a fused chain of
bf16 operations in fp32 (XLA's default excess precision), so the two
part by bf16 ulps (2^-8 relative) that grow over the layers: measured
on these configs, the hidden state within 1.5% of max|h|, logits within
1.5% of max|logit|, the loss within 3e-4 relative and each adapter
gradient within 2.7% in relative L2. The tests hold twice those:
``REL`` = 4e-2 of the max for hidden states, logits and caches, 2e-3
relative for the loss, 6e-2 relative L2 for each gradient.

The Mamba-2 configs (``SSM``, ``CONSIST_SSM``) hold the port to the
reference compiled with that excess precision OFF (every JAX call of
theirs under ``jax.jit(compiler_options={'xla_allow_excess_precision':
False})``): the reference then rounds to bf16 where its code says bf16,
as the port does. With it on, XLA keeps the SSD layer's fused bf16
chains (the conv's sum of products, the gate) in fp32, and the
reference parts from ITSELF compiled without it by up to 1.8% of max|h|
and 8.2% relative L2 on the small dense-trained gradients (zamba's
``dt_bias``, norm 1e-4); the port lies within 0.4% and 1.5% of the
strict reference (tests/test_torch_lm_ssm.py states the measurements).
"""
import contextlib
import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import registry as JR
from repro.core.lora import LoRAConfig as JLoRA
from repro.models import attention as JA
from repro.models import lm as JLM
from repro.models import moe as JMOE
from repro.models import ssm as JSSM
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch.configs import registry as TR
from repro_torch.core.lora import LoRAConfig as TLoRA
from repro_torch.models import attention as TA
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TSSM
from repro_torch.utils.tree import flatten_with_names, tree_leaves, tree_map

torch.set_num_threads(2)

REL = 4e-2           # of max|x|: hidden states, logits, caches
LOSS_REL = 2e-3      # relative: the loss
GRAD_L2 = 6e-2       # relative L2, each adapter gradient
CONSIST_TOL = 5e-2   # decode vs teacher-forced forward, as in the JAX test
# a route may differ from the JAX package's only where the expert it
# picked and the JAX package's have probabilities within this share of
# each other in the port's router (the bf16 drift of the router's input,
# REL of max|h|, moves the probabilities by as much)
ROUTE_TIE = REL

DENSE = ["gemma3-4b", "minitron-4b", "qwen1.5-110b", "nemotron-4-340b"]
MLA_MOE = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]
SSM = ["mamba2-370m", "zamba2-2.7b"]
# tests/test_consistency.py's configs: GQA, padded heads, the ring cache,
# MLA (its ``mla`` key names the MLASpec fields, built in each package)
CONSIST = {
    "gqa": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab=256),
    "padded_heads": dict(n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
                         head_dim=16, d_ff=96, vocab=128, pad_heads_to=4),
    "window_ring": dict(n_layers=7, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, vocab=256, window=8,
                        window_pattern=3, rope_base_global=1e5,
                        qk_norm=True),
    "mla": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=128, vocab=256, attn_kind="mla",
                mla=dict(d_model=64, n_heads=4, q_lora_rank=32,
                         kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                         v_head_dim=16)),
}
# tests/test_consistency.py's Mamba-2 and zamba (shared attention every 2
# layers) configs; the ``mamba`` key names the MambaSpec fields
CONSIST_SSM = {
    "mamba": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                  head_dim=16, d_ff=0, vocab=256, attn_kind="none",
                  mamba=dict(d_model=64, d_inner=128, head_dim=16,
                             d_state=16, chunk=8)),
    "zamba": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                  head_dim=16, d_ff=128, vocab=256, shared_attn_every=2,
                  mamba=dict(d_model=64, d_inner=128, head_dim=16,
                             d_state=16, chunk=8)),
}
PROMPT, STEPS = 16, 8          # decode positions 16..23 wrap a W=8 ring
# configs whose reference runs without XLA's excess precision (docstring)
STRICT_BF16 = {*SSM, *CONSIST_SSM}
_STRICT = {"xla_allow_excess_precision": False}


def _cfgs(name):
    if name in CONSIST or name in CONSIST_SSM:
        kw = dict(CONSIST.get(name) or CONSIST_SSM[name])
        jkw, tkw = dict(kw), dict(kw)
        for key, jcls, tcls in (("mla", JA.MLASpec, TA.MLASpec),
                                ("mamba", JSSM.MambaSpec, TSSM.MambaSpec)):
            if key in kw:
                jkw[key], tkw[key] = jcls(**kw[key]), tcls(**kw[key])
        return (JLM.LMConfig(name="t", lora=JLoRA(rank=4, alpha=64.0), **jkw),
                TLM.LMConfig(name="t", lora=TLoRA(rank=4, alpha=64.0),
                             **tkw))
    return JR.get(name).smoke(), TR.get(name).smoke()


@contextlib.contextmanager
def reference_precision(name):
    """While open, for a ``STRICT_BF16`` config, every ``jax.jit`` (the
    test's own and the JAX package's, e.g. ``serve.generate``'s)
    compiles with XLA's excess precision off."""
    orig = jax.jit
    if name in STRICT_BF16:
        def jit(fun, **kw):
            return orig(fun, **{"compiler_options": _STRICT, **kw})
        jax.jit = jit
    try:
        yield
    finally:
        jax.jit = orig


def _reference(name, fn):
    """``fn`` as the reference runs it: jitted without excess precision
    for a ``STRICT_BF16`` config, eager otherwise."""
    return jax.jit(fn, compiler_options=_STRICT) if name in STRICT_BF16 \
        else fn


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=REL) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)
    return err


@contextlib.contextmanager
def jax_routes(rec: list):
    """While open, every MoE layer of the JAX package also appends its
    router's top-k ids to ``rec``, call by call in layer order (the
    reference's router ops on the layer's own input)."""
    orig = JMOE.moe_apply

    def wrapped(fz, tr, spec, x, lora_scale):
        logits = jnp.einsum("td,de->te",
                            x.reshape(-1, x.shape[-1]).astype(jnp.float32),
                            tr["router"]["w"].astype(jnp.float32))
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), spec.top_k)
        jax.debug.callback(lambda i: rec.append(np.asarray(i)), idx,
                           ordered=True)
        return orig(fz, tr, spec, x, lora_scale)

    JMOE.moe_apply = wrapped
    try:
        yield rec
    finally:
        JMOE.moe_apply = orig


_ROUTE = TMOE.route


class RouteOracle:
    """Teacher-forced routes for the port (module docstring). Each new
    routing call takes the next recorded JAX top-k; a backward pass's
    recomputation of a layer (the same router, the same input) takes
    the one its forward took. ``calls`` holds, routing call by routing
    call, (the share of (token, slot) routes equal to the JAX ones, the
    largest relative probability gap where they differ)."""

    def __init__(self, records):
        self.records = list(records)
        self.calls: list = []
        self.memo: dict = {}

    def route(self, tr, spec, xt):
        gates, idx, probs = _ROUTE(tr, spec, xt)
        key = (tr["router"]["w"].data_ptr(), hashlib.sha1(
            _np(xt).tobytes()).hexdigest())
        if key not in self.memo:
            want = torch.from_numpy(np.asarray(self.records.pop(0),
                                               np.int64))
            assert want.shape == idx.shape
            p = probs.detach()       # no autograd node: a recomputation
            own = p.gather(1, idx)   # must save what the forward saved
            ref = torch.sort(p.gather(1, want), dim=1,
                             descending=True).values
            gap = ((own - ref) / own).abs().max()
            self.calls.append((float((idx == want).float().mean()),
                               float(gap)))
            self.memo[key] = want
        want = self.memo[key]
        g = probs.gather(1, want)
        return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want, probs

    def check(self, calls=None) -> list:
        """The agreement of the first ``calls`` routing calls (all by
        default); each call's routes equal or near ties."""
        got = self.calls[:calls]
        for i, (agree, gap) in enumerate(got):
            assert agree == 1.0 or gap <= ROUTE_TIE, (i, agree, gap)
        return [a for a, _ in got]


@contextlib.contextmanager
def forced_routes(records: list):
    oracle = RouteOracle(records)
    orig, TMOE.route = TMOE.route, oracle.route
    try:
        yield oracle
    finally:
        TMOE.route = orig


def n_moe(cfg) -> int:
    """MoE layers in a model of ``cfg``."""
    return sum(g.repeats * sum(s.ffn == "moe" for s in g.pattern)
               for g in TLM.resolve_groups(cfg))


@functools.lru_cache(maxsize=None)
def _case(name):
    """The JAX package's params and results for one config, once."""
    jc, tc = _cfgs(name)
    p = JLM.init(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(1)
    jt = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.01 * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype)
        if str(path[-1]) == "['b']" else x, p["train"])
    jf = p["frozen"]
    toks = rng.integers(0, jc.vocab, (2, PROMPT + STEPS + 1)).astype(
        np.int32)
    out = {"jc": jc, "tc": tc, "jf": jf, "jt": jt, "toks": toks,
           "tf": convert.params_from_jax(jax.device_get(jf), "cpu"),
           "tt": convert.params_from_jax(jax.device_get(jt), "cpu")}
    return out


@functools.lru_cache(maxsize=None)
def _jax_serving(name):
    c = _case(name)
    jc, jf, jt, toks = c["jc"], c["jf"], c["jt"], c["toks"]
    routes, gen_routes = [], []
    with reference_precision(name):
        prefill = jax.jit(lambda f, t, tok: JLM.prefill(
            f, t, jc, tok, max_seq=PROMPT + STEPS))
        decode = jax.jit(lambda f, t, tok, cache, pos: JLM.decode_step(
            f, t, jc, tok, cache, pos))
    with jax_routes(routes):
        lp, caches, pos = prefill(jf, jt, jnp.asarray(toks[:, :PROMPT]))
        pre_caches = jax.device_get(caches)
        steps = []
        for t in range(PROMPT, PROMPT + STEPS):
            ld, caches = decode(jf, jt, jnp.asarray(toks[:, t:t + 1]),
                                caches, jnp.asarray(t, jnp.int32))
            steps.append(np.asarray(ld))
    with jax_routes(gen_routes), reference_precision(name):
        gen, _ = jserve.generate(jf, jt, jc, jnp.asarray(toks[:, :PROMPT]),
                                 STEPS)
    # JAX's logits along its own greedy path: the near-tie check
    gen = np.asarray(gen)
    path = [np.asarray(lp)]
    _, caches, _ = prefill(jf, jt, jnp.asarray(toks[:, :PROMPT]))
    for i in range(STEPS - 1):
        ld, caches = decode(jf, jt, jnp.asarray(gen[:, i:i + 1]), caches,
                            jnp.asarray(PROMPT + i, jnp.int32))
        path.append(np.asarray(ld)[:, 0])
    return {"prefill": np.asarray(lp), "caches": pre_caches,
            "pos": int(pos), "steps": steps, "routes": routes,
            "gen_routes": gen_routes, "final_caches":
            jax.device_get(caches), "gen": gen, "gen_logits": path}


def check_forward_matches_jax(name):
    c = _case(name)
    with jax_routes([]) as routes:
        hj, auxj = _reference(name, lambda f, t, tok: JLM.forward(
            f, t, c["jc"], tok))(c["jf"], c["jt"],
                                 jnp.asarray(c["toks"][:, :-1]))
        jax.block_until_ready(hj)
    with forced_routes(routes) as oracle:
        ht, auxt = TLM.forward(c["tf"], c["tt"], c["tc"], c["toks"][:, :-1])
    assert ht.dtype == torch.bfloat16
    err = _close(ht, hj)
    agree = oracle.check()
    print(f"{name}: hidden max err {err:.4g}, MoE route agreement by "
          f"layer {agree} (largest gap "
          f"{max([0.0] + [g for _, g in oracle.calls]):.3g}), "
          f"aux {float(auxt):.6g} (JAX {float(auxj):.6g})")
    assert len(agree) == n_moe(c["tc"]) and not oracle.records
    if c["tc"].moe is None:
        assert float(auxt) == float(auxj) == 0.0
    else:
        assert abs(float(auxt) - float(auxj)) <= LOSS_REL * float(auxj)


def check_loss_and_adapter_grads_match_jax(name):
    c = _case(name)
    batch = {"tokens": c["toks"]}
    with jax_routes([]) as routes:
        (lj, mj), gj = _reference(name, jax.value_and_grad(
            lambda t: JLM.loss_fn(c["jf"], t, c["jc"],
                                  {"tokens": jnp.asarray(c["toks"])}),
            has_aux=True))(c["jt"])
    tt = tree_map(lambda t: t.clone().requires_grad_(True), c["tt"])
    # the JAX package's forward routes (its backward recomputes them)
    with forced_routes(routes[:n_moe(c["tc"])]) as oracle:
        lt, mt = TLM.loss_fn(c["tf"], tt, c["tc"], batch)
        names = [n for n, _ in flatten_with_names(tt)]
        gt = torch.autograd.grad(lt, tree_leaves(tt))
    assert len(oracle.check()) == n_moe(c["tc"])
    assert abs(float(lt) - float(lj)) <= LOSS_REL * abs(float(lj))
    assert abs(float(mt["xent"]) - float(mj["xent"])) <= \
        LOSS_REL * abs(float(mj["xent"]))
    gjl = jax.tree.leaves(gj)
    assert len(gjl) == len(gt) == len(names)
    for nm, a, b in zip(names, gjl, gt):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, nm
        assert np.isfinite(b).all(), nm
        assert np.abs(a).max() > 0, nm
        rel = np.linalg.norm(a - b) / np.linalg.norm(a)
        assert rel <= GRAD_L2, (nm, rel)


def test_frozen_tree_takes_no_gradient():
    c = _case("gemma3-4b")
    tt = tree_map(lambda t: t.clone().requires_grad_(True), c["tt"])
    loss, _ = TLM.loss_fn(c["tf"], tt, c["tc"], {"tokens": c["toks"]})
    loss.backward()
    assert all(t.grad is None for t in tree_leaves(c["tf"]))
    assert all(t.grad is not None for t in tree_leaves(tt))


def check_prefill_and_decode_match_jax(name):
    """Prefill logits and every cache, then decode steps at positions
    16..23: past the W = 8 window, so a ring cache wraps."""
    c, j = _case(name), _jax_serving(name)
    with forced_routes(j["routes"]) as oracle:
        lp, caches, pos = TLM.prefill(c["tf"], c["tt"], c["tc"],
                                      c["toks"][:, :PROMPT],
                                      max_seq=PROMPT + STEPS)
        assert pos == j["pos"] == PROMPT
        _close(lp, j["prefill"])
        got, want = tree_leaves(caches), jax.tree.leaves(j["caches"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert str(a.dtype) == f"torch.{b.dtype.name}", (a.dtype, b.dtype)
            _close(a, b)
        for t, ld_j in zip(range(PROMPT, PROMPT + STEPS), j["steps"]):
            ld, caches = TLM.decode_step(c["tf"], c["tt"], c["tc"],
                                         c["toks"][:, t:t + 1], caches, t)
            assert ld.shape == (2, 1, c["tc"].vocab) \
                and ld.dtype == torch.float32
            _close(ld, ld_j)
    assert len(oracle.check()) == (STEPS + 1) * n_moe(c["tc"])


def check_generate_greedy_matches_jax(name):
    """Greedy tokens equal the JAX package's, except past a near tie:
    where the two first part, the JAX logits of the two choices lie
    within twice the logits tolerance."""
    c, j = _case(name), _jax_serving(name)
    with forced_routes(j["gen_routes"]) as oracle:
        toks, timing = tserve.generate(c["tf"], c["tt"], c["tc"],
                                       c["toks"][:, :PROMPT], STEPS,
                                       device="cpu")
    assert toks.dtype == torch.int32 and toks.shape == (2, STEPS)
    assert timing["decode_steps"] == STEPS - 1
    assert timing["prefill_s"] > 0 and timing["decode_s"] > 0
    got = toks.numpy()
    first = STEPS
    for row in range(2):
        diff = np.nonzero(got[row] != j["gen"][row])[0]
        if diff.size:
            i = int(diff[0])
            first = min(first, i)
            lg = j["gen_logits"][i][row]
            gap = lg[j["gen"][row, i]] - lg[got[row, i]]
            assert gap <= 2 * REL * np.abs(lg).max(), (name, row, i, gap)
    # the model calls up to the first parting token saw the JAX inputs
    oracle.check((first + 1) * n_moe(c["tc"]))


def no_drop(cfg):
    """``cfg`` with a MoE capacity at which no token drops (capacity
    factor E/k), so that prefill + decode (other token counts, other
    capacities) and the forward drop nothing either."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def check_decode_matches_teacher_forced_forward(name):
    """The port's own serving path: prefill + a decode step reproduce
    the teacher-forced forward's logits (tests/test_consistency.py's
    check, at its 5e-2); a MoE config at its no-drop capacity."""
    c = _case(name)
    tc, toks = no_drop(c["tc"]), c["toks"][:, :PROMPT + 1]
    lp, caches, pos = TLM.prefill(c["tf"], c["tt"], tc, toks[:, :PROMPT],
                                  max_seq=PROMPT + STEPS)
    ld, _ = TLM.decode_step(c["tf"], c["tt"], tc, toks[:, PROMPT:],
                            caches, pos)
    h, _ = TLM.forward(c["tf"], c["tt"], tc, toks)
    fl = TLM._head_logits(c["tf"], c["tt"], tc, h)
    assert float((lp - fl[:, PROMPT - 1]).abs().max()) < CONSIST_TOL
    assert float((ld[:, 0] - fl[:, PROMPT]).abs().max()) < CONSIST_TOL


def test_resolve_groups_match_jax():
    """gemma3-4b's 34 layers: 5 x (5 local + 1 global) + 4 local."""
    for name in JR.REGISTRY:
        if JR.get(name).kind != "lm":
            continue
        for make in ("smoke", "full"):
            jg = JLM.resolve_groups(getattr(JR.get(name), make)())
            tg = TLM.resolve_groups(getattr(TR.get(name), make)())
            assert [(len(g.pattern), g.repeats) for g in jg] == \
                [(len(g.pattern), g.repeats) for g in tg]
            assert [[(s.mixer, s.ffn, s.window, s.global_rope)
                     for s in g.pattern] for g in jg] == \
                [[(s.mixer, s.ffn, s.window, s.global_rope)
                  for s in g.pattern] for g in tg]
    groups = TLM.resolve_groups(TR.get("gemma3-4b").full())
    assert [(g.repeats, [s.window for s in g.pattern]) for g in groups] == \
        [(5, [1024] * 5 + [None]), (4, [1024])]


def check_init_tree_structure_matches_jax(name):
    """The port's own init: the JAX package's leaves, shapes and dtypes
    (stacked groups keep their leading repeats axis); b is zero, the
    norms one."""
    c = _case(name)
    p = TLM.init(torch.Generator().manual_seed(0), c["tc"], device="cpu")
    for part in ("frozen", "train"):
        ref = convert.params_from_jax(jax.device_get(
            JLM.init(jax.random.PRNGKey(0), c["jc"])[part]), "cpu")
        got = dict(flatten_with_names(p[part]))
        want = dict(flatten_with_names(ref))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
            if k.endswith("/b") or k.endswith("scale"):
                assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("check", [
    check_forward_matches_jax, check_loss_and_adapter_grads_match_jax,
    check_prefill_and_decode_match_jax, check_generate_greedy_matches_jax,
    check_decode_matches_teacher_forced_forward,
    check_init_tree_structure_matches_jax],
    ids=lambda f: f.__name__[len("check_"):])
def test_dense_arch_matches_jax(check, name):
    """The four dense archs' smoke configs (the consistency configs run
    the same checks in tests/test_torch_lm_consistency.py)."""
    check(name)
