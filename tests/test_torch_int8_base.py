"""The int8 frozen base (``repro_torch.core.lora.quantize_frozen_tree``)
against the JAX package's: on JAX ``init`` trees of the smoke configs
carried across by ``convert``, the int8 levels and the fp16 scales are
bit for bit the JAX package's function run op by op (both round half to
even), and the JAX package's quantized tree carries across as int8 and
fp16 leaves. Jitted, the JAX function parts from itself: XLA's CPU
program divides otherwise than the op (numpy's ``w / s``, which the
port and the eager function match), and puts a level one step off
where ``w / s`` lies within an ulp of a half (gemma3-4b's smoke tree:
1 of 24,576 levels of ``groups/0/0/mlp/wi``); the test bounds that by
one level. The LM on the int8 base then matches the JAX package's on
its int8 base within ``test_torch_lm.REL`` of max|logit| (forward and
prefill)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro.configs import registry as JR
from repro.core import lora as JL
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.core import lora as TL
from repro_torch.models import lm as TLM
from repro_torch.utils.tree import flatten_with_names

torch.set_num_threads(2)

ARCHS = ["gemma3-4b", "deepseek-v2-236b", "seamless-m4t-medium",
         "zamba2-2.7b"]


def _frozen(arch):
    entry = JR.get(arch)
    mod = JED if entry.kind == "encdec" else JLM
    return mod.init(jax.random.PRNGKey(0), entry.smoke())["frozen"]


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_frozen_tree_bit_exact(arch):
    jf = _frozen(arch)
    want = convert.params_from_jax(jax.device_get(
        JL.quantize_frozen_tree(jf)), "cpu")
    jitted = convert.params_from_jax(jax.device_get(
        jax.jit(JL.quantize_frozen_tree)(jf)), "cpu")
    got = TL.quantize_frozen_tree(convert.params_from_jax(
        jax.device_get(jf), "cpu"))
    gl, wl = flatten_with_names(got), flatten_with_names(want)
    assert [n for n, _ in gl] == [n for n, _ in wl]
    n_packs = 0
    for (name, g), (_, w), (_, j) in zip(gl, wl,
                                         flatten_with_names(jitted)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(_bits(g), _bits(w)), name
        assert int((g.to(torch.int32) - j.to(torch.int32)).abs().max()) \
            <= (1 if name.endswith("w_q8") else 0), name
        if name.endswith("w_q8"):
            n_packs += 1
            assert g.dtype == torch.int8
            assert int(g.abs().max()) <= 127
        if name.endswith("w_s"):
            assert g.dtype == torch.float16
    assert n_packs > 0
    assert not any(n.endswith("/w") for n, _ in gl)


def test_round_half_to_even_and_the_scale_floor():
    """Levels at exact halves round to even in both packages; an
    all-zero column takes the 1e-8 floor (levels 0)."""
    w = np.zeros((4, 3), np.float32)
    w[:, 0] = [127.0, 2.5, -0.5, 3.5]          # s = 1: halves
    w[:, 1] = [-1.0, 0.25, 0.5, 0.125]
    want = jax.device_get(JL.quantize_frozen_tree({"w": jnp.asarray(w)}))
    got = TL.quantize_frozen_tree({"w": torch.from_numpy(w)})
    assert got["w_q8"][:, 0].tolist() == [127, 2, 0, 4]
    assert got["w_q8"][:, 2].tolist() == [0, 0, 0, 0]
    assert np.array_equal(got["w_q8"].numpy(), np.asarray(want["w_q8"]))
    assert np.array_equal(got["w_s"].view(torch.int16).numpy(),
                          np.asarray(want["w_s"]).view(np.int16))


def test_quantize_on_meta_gives_shapes_and_dtypes():
    p = TLM.init(0, TR.get("gemma3-4b").full(), device="meta")
    q = TL.quantize_frozen_tree(p["frozen"])
    e = q["embed"]
    assert e["w_q8"].device.type == "meta"
    assert e["w_q8"].dtype == torch.int8 and e["w_s"].dtype == torch.float16
    assert tuple(e["w_q8"].shape) == (262144, 2560)
    assert tuple(e["w_s"].shape) == (2560,)
    stacked = [(n, t) for n, t in flatten_with_names(q) if "groups" in n
               and n.endswith("w_s")]
    assert stacked and all(t.ndim == 2 for _, t in stacked)


def test_lm_on_the_int8_base_matches_jax():
    c = base._case("gemma3-4b")
    jq = JL.quantize_frozen_tree(c["jf"])
    tq = TL.quantize_frozen_tree(c["tf"])
    toks = c["toks"][:, :16]
    hj, _ = jax.jit(lambda f, t, x: JLM.forward(f, t, c["jc"], x))(
        jq, c["jt"], jnp.asarray(toks))
    ht, _ = TLM.forward(tq, c["tt"], c["tc"], toks)
    base._close(ht, hj)
    lj, _, _ = jax.jit(lambda f, t, x: JLM.prefill(f, t, c["jc"], x))(
        jq, c["jt"], jnp.asarray(toks))
    lt, _, _ = TLM.prefill(tq, c["tt"], c["tc"], toks)
    base._close(lt, lj)
    # the int8 base moves the logits off the bf16 base's (the levels
    # are not the weights)
    lb, _, _ = TLM.prefill(c["tf"], c["tt"], c["tc"], toks)
    assert float((lb - lt).abs().max()) > 0
