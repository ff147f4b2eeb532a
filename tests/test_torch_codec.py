"""The port's flat-tree wire codec vs the JAX package's, on the ResNet-8
r=8 trainable tree (JAX-initialized, carried across with convert.py).

Wire entries: same names, same order, byte-identical buffers. A message
serialized by either package decodes in the other. Static and measured
wire bytes agree. fedavg_packed_flat over 3 messages agrees to 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jflat
from repro.core import messages as jmsg
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import resnet as jresnet
from repro.utils.tree import flatten_with_names as jnames
from repro_torch import convert
from repro_torch.core import flat as tflat
from repro_torch.core import messages as tmsg
from repro_torch.core.quant import QuantConfig
from repro_torch.utils.tree import flatten_with_names

torch.set_num_threads(1)

BITS = [2, 4, 8]


@pytest.fixture(scope="module")
def jmodel():
    cfg = jresnet.ResNetConfig(arch="resnet8",
                               lora=JLoRAConfig(rank=8, alpha=128.0))
    return jax.device_get(jax.jit(lambda k: jresnet.init(k, cfg))(
        jax.random.PRNGKey(0)))


def _trained(tree, seed):
    """The init tree moved off its zeros, as a client's update would."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        tree)


def _pair(jtree, bits):
    jm = jmsg.pack_message(jax.tree.map(jnp.asarray, jtree),
                           JQuantConfig(bits=bits), flat=True)
    tm = tmsg.pack_message(convert.params_from_jax(jtree, "cpu"),
                           QuantConfig(bits=bits), flat=True)
    return jm, tm


def _assert_entries_equal(a, b):
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, ba), (_, bb) in zip(a, b):
        assert sorted(ba) == sorted(bb), name
        for key in ba:
            x, y = np.asarray(ba[key]), np.asarray(bb[key])
            assert x.dtype == y.dtype and x.shape == y.shape, (name, key)
            assert x.tobytes() == y.tobytes(), (name, key)


def test_flatten_order_matches_jax(jmodel):
    pm = convert.params_from_jax(jmodel, "cpu")
    assert [n for n, _ in flatten_with_names(pm)] == \
        [n for n, _ in jnames(jmodel)]


@pytest.mark.parametrize("bits", BITS)
def test_layout_matches_jax(bits, jmodel):
    jl = jflat.layout_for(jmodel["train"], bits)
    tl = tflat.layout_for(convert.params_from_jax(jmodel["train"], "cpu"),
                          bits)
    assert (tl.c_total, tl.n_max, tl.nw_max) == \
        (jl.c_total, jl.n_max, jl.nw_max)
    for a, b in zip(tl.leaves, jl.leaves):
        assert (a.path, a.shape, a.dtype_str, a.quantized, a.row_start,
                a.rows, a.n_valid) == (b.path, b.shape, b.dtype_str,
                                       b.quantized, b.row_start, b.rows,
                                       b.n_valid)
    np.testing.assert_array_equal(tl.n_valid_vec(), jl.n_valid_vec())


@pytest.mark.parametrize("bits,trained", [(2, True), (4, True), (8, True),
                                          (8, False)])
def test_wire_entries_byte_identical(bits, trained, jmodel):
    tree = _trained(jmodel["train"], bits) if trained else jmodel["train"]
    jm, tm = _pair(tree, bits)
    _assert_entries_equal(tmsg.message_to_wire(tm),
                          jmsg.message_to_wire(jm))


@pytest.mark.parametrize("bits", BITS)
def test_messages_decode_across_packages(bits, jmodel):
    jm, tm = _pair(_trained(jmodel["train"], 10 + bits), bits)
    want = [np.asarray(x) for _, x in jnames(jmsg.unpack_message(jm))]
    # JAX -> port
    got = tmsg.message_from_wire(jmsg.message_to_wire(jm), tm,
                                 device="cpu")
    for (_, x), w in zip(flatten_with_names(tmsg.unpack_message(got)),
                         want):
        np.testing.assert_array_equal(x.numpy(), w)
    # port -> JAX
    back = jmsg.message_from_wire(tmsg.message_to_wire(tm), jm)
    for (_, x), w in zip(jnames(jmsg.unpack_message(back)), want):
        np.testing.assert_array_equal(np.asarray(x), w)
    _assert_entries_equal(jmsg.message_to_wire(back),
                          tmsg.message_to_wire(got))


@pytest.mark.parametrize("bits", BITS)
def test_wire_bytes_match(bits, jmodel):
    jm, tm = _pair(_trained(jmodel["train"], bits), bits)
    ttree = convert.params_from_jax(jmodel["train"], "cpu")
    static = tmsg.message_wire_bytes(ttree, QuantConfig(bits=bits))
    assert static == jmsg.message_wire_bytes(jmodel["train"],
                                             JQuantConfig(bits=bits))
    assert tmsg.packed_wire_bytes(tm) == jmsg.packed_wire_bytes(jm) \
        == static == tm.wire_bytes()
    assert tmsg.message_rank(tm) == jmsg.message_rank(jm) == 8


def test_fp_message_wire_matches_jax(jmodel):
    """Quantization off: the fp tree is the message."""
    tree = _trained(jmodel["train"], 5)
    _assert_entries_equal(
        tmsg.message_to_wire(convert.params_from_jax(tree, "cpu")),
        jmsg.message_to_wire(jax.tree.map(jnp.asarray, tree)))


@pytest.mark.parametrize("bits", [4, 8])
def test_fedavg_packed_flat_matches_jax(bits, jmodel):
    trees = [_trained(jmodel["train"], 20 + i) for i in range(3)]
    w = [3.0, 1.0, 2.0]
    jms = [_pair(t, bits)[0] for t in trees]
    tms = [_pair(t, bits)[1] for t in trees]
    want = jflat.fedavg_packed_flat(jms, jnp.asarray(w))
    got = tflat.fedavg_packed_flat(tms, torch.tensor(w))
    for (n, x), (_, y) in zip(flatten_with_names(got), jnames(want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_codec_default_device_is_cuda(jmodel):
    """Rebuilding a message from the wire defaults to the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tm = _pair(jmodel["train"], 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmsg.message_from_wire(tmsg.message_to_wire(tm), tm)


def test_per_stack_layout_wire_matches_jax():
    """per_stack=True: a leading stack dim's slices get their own rows."""
    rng = np.random.default_rng(9)
    tree = {"blocks": {"w": rng.normal(size=(3, 40, 16)).astype(np.float32),
                       "v": rng.normal(size=(16,)).astype(np.float32)},
            "head": rng.normal(size=(24, 8)).astype(np.float32)}
    jm = jmsg.pack_message(jax.tree.map(jnp.asarray, tree),
                           JQuantConfig(bits=4, per_stack=True), flat=True)
    tm = tmsg.pack_message(convert.params_from_jax(tree, "cpu"),
                           QuantConfig(bits=4, per_stack=True), flat=True)
    assert tm.layout.c_total == jm.layout.c_total == 3 * 16 + 8
    _assert_entries_equal(tmsg.message_to_wire(tm), jmsg.message_to_wire(jm))
    for (_, x), (_, y) in zip(flatten_with_names(tmsg.unpack_message(tm)),
                              jnames(jmsg.unpack_message(jm))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_byte_accounting_matches_jax(jmodel):
    import warnings

    from repro.core import flocora as jflocora
    from repro.core import quant as jquant
    from repro_torch.core import flocora as tflocora
    from repro_torch.core import quant as tquant
    ttree = convert.params_from_jax(jmodel["train"], "cpu")
    for bits in (None, 2, 4, 8):
        jf = jflocora.FLoCoRAConfig(rank=8, alpha=128.0, quant_bits=bits)
        tf = tflocora.FLoCoRAConfig(rank=8, alpha=128.0, quant_bits=bits)
        assert tflocora.round_wire_bytes(ttree, tf) == \
            jflocora.round_wire_bytes(jmodel["train"], jf)
        assert tflocora.tcc(ttree, tf, 100) == \
            jflocora.tcc(jmodel["train"], jf, 100)
    for shape in [(3, 3, 64, 8), (256, 10), (7,)]:
        if len(shape) > 1:
            assert tquant.quantized_tensor_bytes(shape, 4, 1) == \
                jquant.quantized_tensor_bytes(shape, 4, 1)
        assert tquant.fp_tensor_bytes(shape) == jquant.fp_tensor_bytes(shape)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert tquant.tcc_bytes(277_816, 100) == \
            jquant.tcc_bytes(277_816, 100)
