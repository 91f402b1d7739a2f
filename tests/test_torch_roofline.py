"""The port's roofline (`repro_torch.roofline`) against the JAX package's,
on the CPU.

  * `analytic_flops`, `analytic_bytes`, `model_flops` and `active_params`
    equal `repro.roofline`'s bit for bit, for every arch and shape and the
    mesh shapes {}, 16 x 16 and 2 x 16 x 16 (each package's own configs,
    shapes and `segments_for`; the parameter count is the port's, and the
    JAX package's where it is cheap to build);
  * `roofline_terms` gives the JAX package's terms once each side's
    constants are divided out, to 1e-12 relative, with the same dominant
    term; the port carries the H100's constants;
  * the counterpart of `tests/test_roofline.py::test_analytic_flops_vs_hlo`:
    the analytic `fwd_total` within 25 % of `meta_flop_count` of the port's
    `Model.loss` on the meta device, on the same three unrolled configs.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro import roofline as jroof  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.models.transformer import segments_for as jsegments  # noqa: E402
from repro_torch import roofline  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.transformer import segments_for  # noqa: E402

MESHES = [{}, {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
_N_PARAMS: dict[str, int] = {}


def _n_params(name: str) -> int:
    if name not in _N_PARAMS:
        _N_PARAMS[name] = Model(ARCHS[name], device="meta").param_count()
    return _N_PARAMS[name]


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_analytic_model_equals_jax_bitwise(name, shape_name):
    cfg, jcfg = ARCHS[name], JARCHS[name]
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    segs, jsegs = segments_for(cfg), jsegments(jcfg)
    assert segs == jsegs
    n = _n_params(name)
    na = roofline.active_params(cfg, n)
    assert na == jroof.active_params(jcfg, n)
    assert roofline.model_flops(cfg, shape, n, na) \
        == jroof.model_flops(jcfg, jshape, n, na)
    assert roofline.model_flops(cfg, shape, n) \
        == jroof.model_flops(jcfg, jshape, n)
    flops = roofline.analytic_flops(cfg, shape, segs)
    assert flops == jroof.analytic_flops(jcfg, jshape, jsegs)
    assert flops["step_total"] > 0
    for mesh in MESHES:
        got = roofline.analytic_bytes(cfg, shape, segs, mesh, n)
        assert got == jroof.analytic_bytes(jcfg, jshape, jsegs, mesh, n), mesh
        assert got["total"] > 0


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "qwen3-4b", "xlstm-1.3b"])
def test_param_count_equals_jax(name):
    from repro.models import build_model as jbuild
    assert _n_params(name) == jbuild(JARCHS[name]).param_count()


# (compute, memory, collective) in seconds on each side
TERMS = [(1.0, 0.1, 0.0), (0.01, 2.0, 0.0), (0.2, 0.1, 0.3),
         (3.5e-3, 3.5e-3 * (1 - 1e-9), 0.0), (0.0, 0.0, 0.0),
         (1e-6, 7.0, 2.0)]


@pytest.mark.parametrize("secs", TERMS)
def test_roofline_terms_equal_jax_with_constants_divided_out(secs):
    c, m, k = secs
    got = roofline.roofline_terms(c * roofline.PEAK_FLOPS,
                                  m * roofline.HBM_BW, k * roofline.LINK_BW)
    want = jroof.roofline_terms(c * jroof.PEAK_FLOPS, m * jroof.HBM_BW,
                                k * jroof.ICI_BW)
    for key in ("compute_s", "memory_s", "collective_s", "roofline_fraction"):
        assert math.isclose(got[key], want[key], rel_tol=1e-12,
                            abs_tol=1e-300), key
    assert got["dominant"] == want["dominant"]


def test_h100_constants():
    assert roofline.HW == {"peak_flops": 989e12, "peak_flops_f32": 67e12,
                           "hbm_bw": 3.35e12, "link_bw": 450e9,
                           "hbm_bytes": 85_017_493_504}
    t = roofline.roofline_terms(989e12, 3.35e12 / 2, 0)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 0.5
    assert t["dominant"] == "compute_s" and t["roofline_fraction"] == 1.0
    assert roofline.model_flops(None, SHAPES["train_4k"], 10) \
        == 6 * 10 * 256 * 4096


@pytest.mark.parametrize("name,kw,seq", [
    ("granite-3-2b", dict(n_layers=2, d_model=512, n_heads=8, n_kv_heads=4,
                          head_dim=64, d_ff=1024, vocab=4096), 512),
    ("olmoe-1b-7b", dict(n_layers=2, d_model=512, n_heads=8, n_kv_heads=8,
                         head_dim=64, d_ff=256, vocab=4096), 512),
    # the sLSTM steps one token at a time from the host: a shorter sequence
    ("xlstm-1.3b", dict(n_layers=4, d_model=512, n_heads=2, head_dim=256,
                        vocab=4096, slstm_every=2), 128),
])
def test_analytic_flops_vs_meta_count(name, kw, seq):
    """The analytic model matches the FLOPs the port's loss runs within
    25 %: the meta count has every matrix product of the plain versions
    (the chunked attention's masked half included), no elementwise work."""
    cfg = ARCHS[name].replace(dtype="float32", unroll=True, remat="none",
                              attn_chunk=128, ssm_chunk=64, **kw)
    m = Model(cfg, device="meta")
    b = 2
    batch = {"tokens": torch.empty((b, seq), dtype=torch.int32, device="meta"),
             "labels": torch.empty((b, seq), dtype=torch.int32, device="meta")}
    with torch.no_grad():
        loss, flops = roofline.meta_flop_count(m.loss, batch)
    assert loss.device.type == "meta" and loss.shape == ()
    ana = roofline.analytic_flops(cfg, ShapeConfig("v", seq, b, "train"),
                                  segments_for(cfg))
    ratio = ana["fwd_total"] / flops
    assert 0.75 <= ratio <= 1.25, ratio
