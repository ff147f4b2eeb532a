"""The reference quantizer, the fp-simulation codec, ``fedavg_quantized``
and error feedback: the port against the JAX package.

Quantizer and codec at rtol 1e-6 (levels exact); error feedback on both
wires: the residual within fp32 rounding of the JAX package's, the
message's wire bytes identical, the adapters' dtypes restored;
``ef_fold_dropped`` restoring the undelivered mass."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import flocora as jfl
from repro.core import messages as jmsg
from repro.core import quant as jq
from repro.core.flocora import FLoCoRAConfig as JFLoCoRAConfig
from repro.core.quant import QuantConfig as JQuantConfig
from repro_torch.core import aggregation as tagg
from repro_torch.core import flocora as tfl
from repro_torch.core import messages as tmsg
from repro_torch.core import quant as tq
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.utils.tree import flatten_with_names, tree_map

torch.set_num_threads(1)

BITS = [2, 4, 8]


def _tree(seed: int, dtype=np.float32) -> dict:
    """A small adapter-like tree: a conv pair, a dense pair, a stacked
    (per_stack) leaf, a norm vector; one constant column."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.normal(size=shape) * rng.uniform(0.05, 2.0)).astype(dtype)

    t = {"conv": {"a": r(1, 1, 4, 6), "b": r(3, 3, 5, 4)},
         "fc": {"a": r(12, 4), "b": r(4, 7)},
         "stack": r(3, 8, 5), "norm": r(6)}
    t["fc"]["b"][:, 2] = 0.25
    return t


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.asarray(x)), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x, np.float32)


def _close_trees(got, want, rtol=1e-6, atol=1e-7):
    got_n, want_n = flatten_with_names(got), flatten_with_names(want)
    assert [n for n, _ in got_n] == [n for n, _ in want_n]
    for (name, g), (_, w) in zip(got_n, want_n):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_affine_qparams_and_levels_match_jax(bits, symmetric, axis):
    rng = np.random.default_rng(bits + 3 * axis)
    x = (rng.normal(size=(9, 11)) * 3).astype(np.float32)
    x[:, 0] = 0.0
    x[:, 1] = np.abs(x[:, 1])
    x[0, :] = -1.5
    s, z = tq.affine_qparams(torch.from_numpy(x), bits, axis, symmetric)
    js, jz = jq.affine_qparams(jnp.asarray(x), bits, axis, symmetric)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    q = tq.quantize(torch.from_numpy(x), s, z, bits, axis)
    jqv = jq.quantize(jnp.asarray(x), js, jz, bits, axis)
    assert q.dtype == torch.uint8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_allclose(
        tq.dequantize(q, s, z, axis).numpy(),
        np.asarray(jq.dequantize(jqv, js, jz, axis)), rtol=1e-6, atol=1e-7)
    cfg = QuantConfig(bits=bits, symmetric=symmetric)
    jcfg = JQuantConfig(bits=bits, channel_axis=axis, symmetric=symmetric)
    np.testing.assert_allclose(
        tq.quant_dequant(torch.from_numpy(x), cfg, axis).numpy(),
        np.asarray(jq.quant_dequant(jnp.asarray(x), jcfg)), rtol=1e-6,
        atol=1e-7)


def test_symmetric_range_holds_both_extremes():
    """The restricted-range symmetric grid represents 0 and +-amax
    exactly (the JAX package's saturation fix)."""
    x = torch.tensor([[-2.0, 0.0, 1.0, 2.0]]).T
    y = tq.quant_dequant(x, QuantConfig(bits=4, symmetric=True))
    assert y[0, 0] == -2.0 and y[1, 0] == 0.0 and y[3, 0] == 2.0


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("per_stack", [False, True])
def test_encode_decode_roundtrip_match_jax(bits, per_stack):
    tree = _tree(bits)
    cfg = QuantConfig(bits=bits, per_stack=per_stack)
    jcfg = JQuantConfig(bits=bits, per_stack=per_stack)
    enc, jenc = tmsg.encode(_t(tree), cfg), jmsg.encode(_j(tree), jcfg)
    for key in ("a", "b"):
        np.testing.assert_array_equal(enc["conv"][key]["q"].numpy(),
                                      np.asarray(jenc["conv"][key]["q"]))
    np.testing.assert_array_equal(enc["stack"]["scale"].numpy().shape,
                                  np.asarray(jenc["stack"]["scale"]).shape)
    _close_trees(tmsg.decode(enc, cfg, _t(tree)),
                 jmsg.decode(jenc, jcfg, _j(tree)))
    _close_trees(tmsg.roundtrip(_t(tree), cfg),
                 jmsg.roundtrip(_j(tree), jcfg))
    assert tmsg.roundtrip(_t(tree), QuantConfig()) is not None


def test_symmetric_config_packs_the_asymmetric_wire():
    """As in the JAX package, the wire pack ignores ``symmetric``."""
    tree = _t(_tree(1))
    a = tmsg.message_to_wire(tmsg.pack_message(tree, QuantConfig(bits=4)))
    b = tmsg.message_to_wire(tmsg.pack_message(
        tree, QuantConfig(bits=4, symmetric=True)))
    for (na, ba), (nb, bb) in zip(a, b):
        assert na == nb
        for key in ba:
            np.testing.assert_array_equal(ba[key], bb[key])


@pytest.mark.parametrize("bits", [None, 4, 8])
def test_fedavg_quantized_and_server_round_match_jax(bits):
    trees = [_tree(10 + i) for i in range(3)]
    w = np.asarray([3.0, 1.0, 2.0], np.float32)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    got = tagg.fedavg_quantized(_t(stacked), torch.from_numpy(w),
                                QuantConfig(bits=bits))
    want = jagg.fedavg_quantized(_j(stacked), jnp.asarray(w),
                                 JQuantConfig(bits=bits))
    _close_trees(got, want, rtol=1e-6, atol=1e-6)
    _close_trees(tfl.server_round(_t(stacked), torch.from_numpy(w),
                                  FLoCoRAConfig(quant_bits=bits)),
                 jfl.server_round(_j(stacked), jnp.asarray(w),
                                  JFLoCoRAConfig(quant_bits=bits)),
                 rtol=1e-6, atol=1e-6)


def test_fleet_tcc_bytes_matches_jax():
    tree = _tree(0)
    for bits in (None, 2, 8):
        assert tfl.fleet_tcc_bytes(_t(tree), FLoCoRAConfig(quant_bits=bits),
                                   7) == jfl.fleet_tcc_bytes(
            _j(tree), JFLoCoRAConfig(quant_bits=bits), 7)


def test_ef_encode_matches_jax():
    tree, res = _tree(2), _tree(3)
    res = {k: (v * 0.01 if not isinstance(v, dict) else
               {kk: vv * 0.01 for kk, vv in v.items()})
           for k, v in res.items()}
    recon, new = tagg.ef_encode(_t(tree), _t(res), QuantConfig(bits=4))
    jrecon, jnew = jagg.ef_encode(_j(tree), _j(res), JQuantConfig(bits=4))
    _close_trees(recon, jrecon)
    _close_trees(new, jnew, rtol=1e-5, atol=1e-6)


def _wire_equal(msg, jmsg_):
    got, want = tmsg.message_to_wire(msg), jmsg.message_to_wire(jmsg_)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]))


@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_ef_encode_packed_matches_jax(flat, bits):
    """Residual, wire bytes and dtypes on both wires, from a bf16 tree
    (the compensated tree is fp32; the message must say bf16)."""
    tree = _tree(4, dtype=ml_dtypes.bfloat16)
    res = jax.tree.map(lambda x: (0.01 * np.asarray(x, np.float32)), _tree(5))
    ttree = tree_map(lambda x: torch.from_numpy(
        np.asarray(x, np.float32)).to(torch.bfloat16), tree)
    msg, new = tagg.ef_encode_packed(ttree, _t(res), QuantConfig(bits=bits),
                                     flat=flat)
    jm, jnew = jagg.ef_encode_packed(_j(tree), _j(res),
                                     JQuantConfig(bits=bits), flat=flat)
    _wire_equal(msg, jm)
    _close_trees(new, jnew, rtol=1e-5, atol=1e-6)
    dec = tmsg.unpack_message(msg)
    assert all(x.dtype == torch.bfloat16 for _, x in flatten_with_names(dec))
    assert tagg.message_is_packed(msg)
    assert not tagg.message_is_packed(ttree)
    agg = tagg.fedavg_packed([msg, msg], torch.tensor([1.0, 3.0]))
    assert all(x.dtype == torch.bfloat16 for _, x in flatten_with_names(agg))


@pytest.mark.parametrize("flat", [True, False])
def test_ef_fold_dropped_recovers_the_lost_mass(flat):
    """After a dropped uplink the residual holds the whole compensated
    signal x + e, so nothing the client meant to send is lost."""
    tree, res = _t(_tree(6)), _t(_tree(7))
    res = tree_map(lambda x: 0.01 * x, res)
    msg, new = tagg.ef_encode_packed(tree, res, QuantConfig(bits=2),
                                     flat=flat)
    folded = tagg.ef_fold_dropped(new, msg)
    _close_trees(folded, tree_map(lambda x, e: x + e, tree, res),
                 rtol=1e-5, atol=1e-6)
    jmsg_, jnew = jagg.ef_encode_packed(_j(_tree(6)), jax.tree.map(
        lambda x: 0.01 * x, _j(_tree(7))), JQuantConfig(bits=2), flat=flat)
    _close_trees(folded, jagg.ef_fold_dropped(jnew, jmsg_), rtol=1e-5,
                 atol=1e-6)


def test_client_uplink_carries_the_residual():
    tree = _t(_tree(8))
    cfg = FLoCoRAConfig(quant_bits=4, error_feedback=True, flat_wire=False)
    msg, res = tfl.client_uplink(tree, cfg)
    assert res is not None and tagg.message_is_packed(msg)
    msg2, res2 = tfl.client_uplink(tree, cfg, res)
    jcfg = JFLoCoRAConfig(quant_bits=4, error_feedback=True, flat_wire=False)
    jm, jres = jfl.client_uplink(_j(_tree(8)), jcfg)
    jm2, jres2 = jfl.client_uplink(_j(_tree(8)), jcfg, jres)
    _wire_equal(msg2, jm2)
    _close_trees(res2, jres2, rtol=1e-5, atol=1e-6)
    plain, none = tfl.client_uplink(tree, FLoCoRAConfig(quant_bits=4))
    assert none is None and tagg.message_is_packed(plain)


def test_replace_dtypes_restores_leaf_dtypes():
    tree = tree_map(lambda x: x.to(torch.bfloat16), _t(_tree(9)))
    fp32 = tree_map(lambda x: x.to(torch.float32), tree)
    msg = tmsg.pack_message(fp32, QuantConfig(bits=8), flat=True)
    again = msg.replace_dtypes(tree)
    assert again.payload is msg.payload
    assert all(x.dtype == torch.bfloat16
               for _, x in flatten_with_names(again.unpack()))
    assert all(x.dtype == torch.bfloat16 for x in again.fp_leaves)


def test_error_feedback_aggregator_stores_host_numpy():
    agg = tagg.ErrorFeedbackFedAvg(QuantConfig(bits=8), 4)
    like = _t(_tree(0))
    zero = agg.residual(3, like)
    assert all(float(x.abs().max()) == 0 for _, x in flatten_with_names(zero))
    agg.store_residual(3, tree_map(lambda x: x + 1.0, like))
    assert isinstance(agg.residuals[3]["norm"], np.ndarray)
    back = agg.residual(3, like)
    _close_trees(back, tree_map(lambda x: x + 1.0, like))
    other = {"conv": {"a": torch.zeros(2, 2), "b": torch.zeros(2, 2)}}
    assert float(agg.residual(3, other)["conv"]["a"].abs().max()) == 0
