"""The port's int8 K/V decode path (``models/attention.py``: ``quantize_kv_row``,
``dequantize_kv``, ``gqa_decode``'s int8 branch; ``decode_cache_specs(...,
kv_int8=True)``) against the JAX package's, the four cases of JAX's
``tests/test_kv_int8.py`` on the same float32 inputs made with numpy from a
seed:

* quantization and its inverse bitwise equal to JAX's, within half a step of
  the row's scale of the input;
* attention over the dequantized cache equal to JAX's within 1e-5, and within
  2% of attention over the float32 cache;
* ``gqa_decode`` on int8 caches, both packages' projections given JAX's
  q/k/v rows: the caches and scales it writes bitwise equal to JAX's,
  written in place, ``y`` within 1e-5 of JAX's and within 5% of the float32
  cache's;
* three ``decode_step``s of Granite-8B's smoke config (float32) on
  ``decode_cache_specs(kv_int8=True)`` caches: int8 caches and float32 scales
  of JAX's shapes, logits within 1e-5 of JAX's, the int8 caches equal and
  the scales within 1e-6 (each is the largest |value| of a K/V row over 127,
  and the frameworks' products round the rows in the last bit), still int8.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch_threads  # noqa: F401  (sizes this worker's torch thread pool)

from repro import config as jconfig
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models.params import init_params as jinit_params
from repro_torch import config as tconfig
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.params import params_from_numpy

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _granite():
    jcfg = dataclasses.replace(jconfig.get_smoke_arch("granite_8b"), dtype="float32")
    return jcfg, tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def test_quantize_and_dequantize_are_bitwise_jax():
    x = (np.random.default_rng(0).standard_normal((4, 8, 32)) * 3.0).astype(np.float32)
    x[0, 0] = 0.0   # an all-zero row takes the 1e-8 floor of the scale
    jq, js = jattn.quantize_kv_row(jnp.asarray(x))
    tq, ts = tattn.quantize_kv_row(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (4, 8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = tattn.dequantize_kv(tq, ts)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jattn.dequantize_kv(jq, js)))
    assert float((deq - _t(x)).abs().max() / np.abs(x).max()) < 1.0 / 127
    # bfloat16 rows are quantized from their float32 widening, as in JAX
    xb = jnp.asarray(x, jnp.bfloat16)
    tb = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    for got, want in zip(tattn.quantize_kv_row(tb), jattn.quantize_kv_row(xb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attention_over_the_int8_cache_matches_jax():
    rng = np.random.default_rng(1)
    b, s, hkv, hq, d = 2, 64, 2, 8, 32
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    lengths = np.asarray([48, 64], np.int32)
    (kq, ks), (vq, vs) = tattn.quantize_kv_row(_t(k)), tattn.quantize_kv_row(_t(v))
    out = tattn.decode_attention(_t(q), tattn.dequantize_kv(kq, ks), tattn.dequantize_kv(vq, vs),
                                 _t(lengths))
    (jkq, jks), (jvq, jvs) = jattn.quantize_kv_row(jnp.asarray(k)), jattn.quantize_kv_row(
        jnp.asarray(v))
    want = jattn.decode_attention(jnp.asarray(q), jattn.dequantize_kv(jkq, jks),
                                  jattn.dequantize_kv(jvq, jvs), jnp.asarray(lengths))
    np.testing.assert_allclose(_np(out), np.asarray(want), **F32)
    full = tattn.decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    np.testing.assert_allclose(_np(out), _np(full), rtol=0.02, atol=0.02)


def test_gqa_decode_int8_writes_in_place_as_jax(monkeypatch):
    jcfg, tcfg = _granite()
    jp = jinit_params(jax.random.PRNGKey(0), jattn.gqa_defs(jcfg, jnp.float32))
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(2)
    b, cap, hkv, hd = 2, 16, tcfg.num_kv_heads, tcfg.resolved_head_dim
    x = (rng.standard_normal((b, 1, tcfg.d_model)) * 0.1).astype(np.float32)
    pos = np.asarray([3, 7], np.int32)
    # the same q/k/v rows in both packages: the write is then held bitwise
    qkv = [np.asarray(a) for a in jattn._project_qkv(jp, jcfg, jnp.asarray(x),
                                                     jnp.asarray(pos)[:, None])]
    monkeypatch.setattr(jattn, "_project_qkv", lambda *a: tuple(map(jnp.asarray, qkv)))
    monkeypatch.setattr(tattn, "project_qkv", lambda *a: tuple(map(_t, qkv)))
    jout = jattn.gqa_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                            jnp.zeros((b, cap, hkv, hd), jnp.int8),
                            jnp.zeros((b, cap, hkv, hd), jnp.int8),
                            jnp.zeros((b, cap, hkv), jnp.float32),
                            jnp.zeros((b, cap, hkv), jnp.float32))
    caches = [torch.zeros((b, cap, hkv, hd), dtype=torch.int8) for _ in range(2)] + [
        torch.zeros((b, cap, hkv), dtype=torch.float32) for _ in range(2)]
    tout = tattn.gqa_decode(tp, tcfg, _t(x), _t(pos), *caches)
    assert all(got is given for got, given in zip(tout[1:], caches))   # in place
    np.testing.assert_allclose(_np(tout[0]), np.asarray(jout[0]), **F32)
    for got, want in zip(tout[1:], jout[1:]):
        assert got.dtype == {jnp.int8: torch.int8, jnp.float32: torch.float32}[want.dtype.type]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(caches[0][0, 3].abs().sum()) > 0 and int(caches[0][0, 2].abs().sum()) == 0
    # the float32 cache's output is within 5%, as JAX's test holds
    y, kc, _, ks, vs = tattn.gqa_decode(tp, tcfg, _t(x), _t(pos),
                                        torch.zeros((b, cap, hkv, hd)), torch.zeros((b, cap, hkv, hd)))
    assert ks is None and vs is None and kc.dtype == torch.float32
    np.testing.assert_allclose(_np(tout[0]), _np(y), rtol=0.05, atol=0.05)


@functools.cache
def _jax_int8_decode(steps: int):
    jcfg, _ = _granite()
    jp = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    structs, _ = jmodel.decode_cache_specs(jcfg, 2, 32, kv_int8=True)
    caches = jax.tree.map(lambda sp: jnp.zeros(sp.shape, sp.dtype), structs)
    tok = jnp.asarray([[1], [2]], jnp.int32)
    pos = jnp.zeros((2,), jnp.int32)
    fed, logits = [], []
    for _ in range(steps):
        fed.append(np.asarray(tok))
        lg, caches = jmodel.decode_step(jp, jcfg, tok, pos, caches)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        pos = pos + 1
    return (jp, jax.tree.map(lambda sp: (sp.shape, sp.dtype), structs), fed, logits,
            jax.tree.map(np.asarray, caches))


def test_decode_steps_on_int8_cache_specs_match_jax():
    jcfg, tcfg = _granite()
    jp, jspecs, fed, jlogits, jcaches = _jax_int8_decode(3)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    specs = tmodel.decode_cache_specs(tcfg, 2, 32, kv_int8=True)
    want = {n: (tuple(shape), np.dtype(dt).name) for n, (shape, dt) in jspecs[0]["blk0"].items()}
    got = {n: (sp.shape, str(sp.dtype).removeprefix("torch.")) for n, sp in specs[0]["blk0"].items()}
    assert got == want and got["k"][1] == "int8" and got["k_scale"][1] == "float32"
    caches = [{"blk0": {n: torch.zeros(sp.shape, dtype=sp.dtype)
                        for n, sp in specs[0]["blk0"].items()}}]
    given = dict(caches[0]["blk0"])
    pos = torch.zeros((2,), dtype=torch.int32)
    for step, tok in enumerate(fed):
        lg, caches = tmodel.decode_step(tp, tcfg, _t(tok), pos, caches)
        np.testing.assert_allclose(_np(lg), jlogits[step], **F32, err_msg=f"step {step}")
        pos = pos + 1
    assert all(caches[0]["blk0"][n] is t for n, t in given.items())
    for n, t in caches[0]["blk0"].items():
        assert t.dtype == (torch.int8 if n in ("k", "v") else torch.float32), n
        if n in ("k", "v"):
            np.testing.assert_array_equal(t.numpy(), jcaches[0]["blk0"][n], err_msg=n)
        else:
            np.testing.assert_allclose(t.numpy(), jcaches[0]["blk0"][n], rtol=1e-6, atol=0,
                                       err_msg=n)
    assert int(caches[0]["blk0"]["k"][:, :, 3:].abs().sum()) == 0   # three rows written
