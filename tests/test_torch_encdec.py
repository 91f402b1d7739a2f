"""The port's encoder-decoder family (seamless-m4t-medium: an encoder over
projected audio frames, a causal decoder with cross-attention) against the
JAX package, on the CPU.

The same numpy inputs and weights go through the JAX function and the
port's, in f32 at `reduced(seamless-m4t-medium)` (2 encoder and 2 decoder
layers, 8 frames of 32, d 64, MHA), the JAX model's weights carried by
`convert.lm_params_from_numpy`.  The model-level checks are
`test_torch_frontend.py`'s helpers, with their bars.  Here besides:

  * `encode_kv` and `cross_attention` (with and without `enc_valid_len`)
    and the encoder's `_bidir_attention` within 1e-6 of max(1, max |want|);
  * the caches' static cross keys and values "ck", "cv" (frame length)
    within 1e-4 after a prefill, and the engine's zeros of `init_cache`;
  * the decay rule: the encoder's stacked norm1 / norm2 decay (rank 2 in
    the JAX layout), fe_norm, encoder/norm and final_norm do not;
  * the compressed train step quantizes each stacked encoder leaf with
    one scale (`param_groups`);
  * `embed_sequences` within 1e-4 of the JAX package's (its decoder
    attends to the encoder's output);
  * the full config's 978,971,648 parameters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.curation import embed_sequences as jembed  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.data.curation import embed_sequences  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.training import param_groups  # noqa: E402
from test_torch_frontend import (  # noqa: E402
    _batch, _cfgs, _close, _jbatch, _pair, check_adamw_update,
    check_decode_after_prefill, check_engine_tokens, check_launchers,
    check_loss_and_gradients, check_param_count_full, check_prefill,
    check_train_steps,
)

ARCH = "seamless-m4t-medium"


def _np_params(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("valid", [False, True])
def test_encode_kv_and_cross_attention_match_jax(valid):
    jcfg, cfg = _cfgs(ARCH)
    p = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.key(1), jcfg, cross=True))
    assert sorted(p) == ["cross_wk", "cross_wo", "cross_wq", "cross_wv"]
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(2, cfg.frontend_len, cfg.d_model)).astype(
        np.float32)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    lens = np.array([3, cfg.frontend_len], np.int32) if valid else None
    jkv = jattn.encode_kv(p, jnp.asarray(enc), jcfg)
    want = jattn.cross_attention(p, jnp.asarray(x), jcfg, jkv,
                                 None if lens is None else jnp.asarray(lens))
    tp = _np_params(p)
    kv = attn.encode_kv(tp, torch.from_numpy(enc), cfg)
    got = attn.cross_attention(tp, torch.from_numpy(x), cfg, kv,
                               None if lens is None else torch.from_numpy(lens))
    for k in ("k", "v"):
        _close(kv[k].numpy(), jkv[k], 1e-6, f"encode_kv {k}")
    _close(got.numpy(), want, 1e-6, "cross_attention")
    if valid:
        # the masked frames carry no weight: changing them changes nothing
        kv2 = {k: t.clone() for k, t in kv.items()}
        kv2["v"][0, 3:] += 100.0
        again = attn.cross_attention(tp, torch.from_numpy(x), cfg, kv2,
                                     torch.from_numpy(lens))
        assert torch.equal(again[0], got[0])


def test_bidir_attention_matches_jax():
    jcfg, cfg = _cfgs(ARCH)
    p = jax.tree.map(np.asarray, jtransformer.init_block(
        jax.random.key(2), jcfg, "enc_attn_mlp"))
    assert {k: v.shape for k, v in p.items()} == {
        k: s for k, (s, _) in transformer.block_shapes(
            cfg, "enc_attn_mlp", torch.float32).items()}
    h = np.random.default_rng(2).normal(
        size=(2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    pos = np.arange(cfg.frontend_len, dtype=np.float32)
    want, (jk, jv) = jtransformer._bidir_attention(p, jnp.asarray(h), jcfg,
                                                   jnp.asarray(pos))
    got, (k, v) = transformer._bidir_attention(
        _np_params(p), torch.from_numpy(h), cfg, torch.from_numpy(pos))
    _close(got.numpy(), want, 1e-6, "bidir out")
    _close(k.numpy(), jk, 1e-6, "bidir k")
    _close(v.numpy(), jv, 1e-6, "bidir v")


def test_decoder_block_shapes_match_jax():
    jcfg, cfg = _cfgs(ARCH)
    p = jtransformer.init_block(jax.random.key(3), jcfg, "dec_attn_mlp")
    assert {k: v.shape for k, v in p.items()} == {
        k: s for k, (s, _) in transformer.block_shapes(
            cfg, "dec_attn_mlp", torch.float32).items()}


def test_seamless_prefill_and_caches_match_jax():
    ct = check_prefill(ARCH)
    cfg = _cfgs(ARCH)[1]
    assert sorted(ct["seg_00"]) == ["ck", "cv", "k", "v"]
    assert ct["seg_00"]["ck"].shape[2] == cfg.frontend_len
    assert ct["seg_00"]["k"].shape[2] == 21


def test_seamless_encode_matches_jax():
    jm, params, tm = _pair(ARCH, seed=6)
    batch = _batch(tm.cfg, 2, 4, seed=6)
    want = jm._encode(params, _jbatch(batch))
    with torch.inference_mode():
        got = tm._encode(batch)
        x, n_prefix = tm._embed(batch)
    _close(got.numpy(), want, 1e-4, "encoder output")
    assert n_prefix == 0 and x.shape == (2, 4, tm.cfg.d_model)


def test_seamless_decode_after_prefill_matches_jax():
    check_decode_after_prefill(ARCH)


def test_seamless_loss_and_gradients_match_jax():
    names = set(check_loss_and_gradients(ARCH))
    assert {"encoder/norm", "encoder/segments/wq", "encoder/segments/norm1",
            "frontend/fe_norm", "segments/seg_00/cross_wq",
            "segments/seg_00/norm_x"} <= names


def test_seamless_adamw_update_matches_jax_leaf_by_leaf():
    # the encoder's (enc_layers, D) norm1 / norm2 and the decoder's stacked
    # norms decay; fe_norm, encoder/norm and final_norm are 1-d leaves
    check_adamw_update(ARCH, {"final_norm", "frontend/fe_norm",
                              "encoder/norm"})


@pytest.mark.parametrize("compress", [False, True])
def test_seamless_train_steps_match_jax(compress):
    tree = check_train_steps(ARCH, compress)
    assert tree.params["encoder"]["segments"]["wq"].shape[0] == 2


def test_param_groups_stack_the_encoder_leaves():
    cfg = _cfgs(ARCH)[1]
    names = [n for n, _ in Model(cfg, device="meta").named_parameters()]
    groups = param_groups(names)
    assert groups["encoder.segments.0.wq"] == groups[
        "encoder.segments.1.wq"] == "encoder/segments/wq"
    assert groups["encoder.norm"] == "encoder.norm"
    assert groups["frontend.fe_w1"] == "frontend.fe_w1"
    assert groups["segments.seg_00.1.cross_wk"] == "segments/seg_00/cross_wk"


def test_seamless_serve_engine_tokens_identical_to_jax():
    tc = check_engine_tokens(ARCH)
    # the engine never prefills the encoder: its cross keys and values stay
    # init_cache's zeros, and its cross-attention adds 0 (as the reference)
    assert not tc["seg_00"]["ck"].any() and not tc["seg_00"]["cv"].any()


def test_seamless_embed_sequences_matches_jax():
    jm, params, tm = _pair(ARCH, seed=8)
    batches = [_batch(tm.cfg, 3, 10, seed=10 + i) for i in range(2)]
    want = jembed(jm, params, [_jbatch(b) for b in batches])
    got = embed_sequences(tm, batches)
    assert got.dtype == torch.float32 and got.shape == (6, tm.cfg.d_model)
    _close(got.numpy(), want, 1e-4, "embed_sequences")


def test_seamless_param_count_full_on_meta():
    m = check_param_count_full(ARCH, 978_971_648)
    enc = sum(p.numel() for p in m.encoder.parameters())
    assert enc == 201_352_192
    assert sum(p.numel() for p in m.frontend.values()) == 1_213_440
    assert m.tok_embed.numel() == m.lm_head.numel() == 262_354_944


def test_seamless_launchers_run_on_cpu(capsys, monkeypatch):
    check_launchers(capsys, monkeypatch, ARCH)
