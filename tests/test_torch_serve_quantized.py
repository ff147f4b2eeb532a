"""The port's quantized-serving driver
(``repro_torch.launch.serve_quantized.run``) against the JAX package's
``examples/serve_quantized.py`` on its ``edge-lm`` config: the example's
steps run here with the JAX package's functions, from one JAX ``init``
tree whose adapters the example moves (``jax.random``), carried across
by ``convert``. The int4 and fp32 wire bytes are equal, the decoded
adapters are bit for bit the JAX package's, the greedy tokens are equal
up to a near tie (``test_torch_lm``'s rule: where they first part, the
JAX logits of the two choices lie within twice ``REL`` of max|logit|;
row 0 parts at its 4th token) and the prefill logits on the decoded
adapters lie within ``test_torch_lm.REL`` of max|logit|; the
multi-tenant step (8 clients, ranks 4 and 8, int4, the fused path) lies
within ``SERVE_TOL`` = 1e-4 of max|y| of both its own merged oracle and
the JAX engine's output (fp32 products, as tests/test_torch_serve.py
holds them)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro import serve as jserve
from repro.core import messages as jmessages
from repro.core.lora import LoRAConfig as JLoRA
from repro.core.quant import QuantConfig as JQ
from repro.models import lm as JLM
from repro_torch import convert
from repro_torch.launch import serve_quantized
from repro_torch.models import lm as TLM
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

SERVE_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_example():
    """The example's three steps in the JAX package."""
    cfg = JLM.LMConfig(name="edge-lm", n_layers=4, d_model=128, n_heads=4,
                       n_kv_heads=2, head_dim=32, d_ff=512, vocab=512,
                       lora=JLoRA(rank=8, alpha=128.0), head_mode="lora")
    params = JLM.init(jax.random.PRNGKey(0), cfg)
    frozen, train = params["frozen"], params["train"]
    train = jax.tree.map(
        lambda x: x + 0.02 * jax.random.normal(jax.random.PRNGKey(1),
                                               x.shape, x.dtype), train)
    qcfg = JQ(bits=4)
    out = {"cfg": cfg, "frozen": frozen, "train": train,
           "wire_bytes": jmessages.message_wire_bytes(train, qcfg),
           "fp_bytes": jmessages.message_wire_bytes(train, JQ())}
    train_edge = jmessages.roundtrip(train, qcfg)
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab, (2, 12)), jnp.int32)
    toks, _ = jserve.generate(frozen, train_edge, cfg, prompt, gen=9,
                              max_seq=32)
    logits, caches, _ = JLM.prefill(frozen, train_edge, cfg, prompt,
                                    max_seq=32)
    path = [np.asarray(logits)]        # the JAX logits on its own path
    decode = jax.jit(lambda c, tok, pos: JLM.decode_step(
        frozen, train_edge, cfg, tok, c, pos))
    for i in range(8):
        ld, caches = decode(caches, toks[:, i:i + 1],
                            jnp.asarray(12 + i, jnp.int32))
        path.append(np.asarray(ld)[:, 0])
    weights, store = jserve.make_store(n_clients=8, d_model=cfg.d_model,
                                       n_layers=2, ranks=(4, 8), bits=4,
                                       seed=0)
    cache = jserve.AdapterCache(capacity_bytes=1 << 20, qcfg=store.qcfg)
    engine = jserve.AdapterServingEngine(weights, scale=0.5,
                                         qcfg=store.qcfg, cache=cache,
                                         fetch=store.fetch)
    cids = list(range(8))
    engine.admit(cids)
    x = jnp.asarray(rng.standard_normal((8, cfg.d_model)) * 0.5,
                    jnp.float32)
    out.update(train_edge=jax.device_get(train_edge),
               prompt=np.asarray(prompt), tokens=np.asarray(toks),
               logits=np.asarray(logits), path=path, x=np.asarray(x),
               y=np.asarray(engine.step(x, cids)))
    return out


@functools.lru_cache(maxsize=None)
def _port():
    j = _jax_example()
    params = {"frozen": convert.params_from_jax(
        jax.device_get(j["frozen"]), "cpu"),
        "train": convert.params_from_jax(jax.device_get(j["train"]), "cpu")}
    return serve_quantized.run(serve_quantized.edge_cfg(), "cpu", params,
                               log=None), params


def test_edge_cfg_is_the_example_config():
    cfg = serve_quantized.edge_cfg()
    want = _jax_example()["cfg"]
    for field in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab", "head_mode"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert (cfg.lora.rank, cfg.lora.alpha) == (want.lora.rank,
                                               want.lora.alpha)


def test_wire_bytes_and_roundtrip_match_jax():
    j, (out, _) = _jax_example(), _port()
    assert out["wire_bytes"] == j["wire_bytes"]
    assert out["fp_bytes"] == j["fp_bytes"]
    assert out["wire_bytes"] < out["fp_bytes"]
    got, want = tree_leaves(out["train_edge"]), jax.tree.leaves(
        j["train_edge"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_generate_on_the_decoded_adapters_matches_jax():
    j, (out, params) = _jax_example(), _port()
    assert np.array_equal(out["prompt"], j["prompt"])
    got = out["tokens"].numpy()
    assert got.shape == (2, 9) and got.dtype == np.int32
    for row in range(2):
        diff = np.nonzero(got[row] != j["tokens"][row])[0]
        if diff.size:
            i = int(diff[0])
            lg = j["path"][i][row]
            gap = lg[j["tokens"][row, i]] - lg[got[row, i]]
            assert gap <= 2 * base.REL * np.abs(lg).max(), (row, i, gap)
    logits, _, _ = TLM.prefill(params["frozen"], out["train_edge"],
                               serve_quantized.edge_cfg(), out["prompt"],
                               max_seq=32)
    base._close(logits, j["logits"])
    assert out["timing"]["decode_steps"] == 8


def test_multi_tenant_step_matches_oracle_and_jax():
    j, (out, _) = _jax_example(), _port()
    assert np.array_equal(out["x"].numpy(), j["x"])
    y, yo = out["y"].numpy(), out["y_oracle"].numpy()
    assert y.shape == (8, 128) and np.isfinite(y).all()
    scale = float(np.abs(yo).max())
    assert out["err"] == float(np.abs(y - yo).max()) <= SERVE_TOL * scale
    assert float(np.abs(y - j["y"]).max()) <= SERVE_TOL * scale
    assert out["cache"]["entries"] == 8 and out["cache"]["misses"] == 8


def test_run_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_quantized.run(serve_quantized.edge_cfg())
