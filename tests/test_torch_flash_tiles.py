"""Host-side logic of the port's bf16 flash-attention and rmsnorm kernels,
on the CPU.

The CUDA kernels run only on a card (`chip_smoke.py` holds them against
their plain versions there).  What they rest on is decided in plain Python
and checked here without one: the tensor-core flash kernel's tile table
for each head dim (read from `csrc/flash_attention.cu`, which holds the
only copy) against the card's shared memory and registers, the TMA geometry (extents and byte strides)
the wrapper derives from contiguous and transposed views, the refusal of
views TMA cannot read, and rmsnorm's choice between its one-read and
two-pass kernels (and the per-kernel launch counts of `ops.rmsnorm`).
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

CSRC = Path(fa.__file__).resolve().parent / "csrc"
SMEM_PER_BLOCK = 232_448      # an H100 block's dynamic shared memory
REGS_PER_SM = 65_536


def _tc_source():
    src = (CSRC / "flash_attention.cu").read_text()
    return src[src.index("namespace tc {"):]


def _tc_constant(name):
    return re.search(rf"constexpr int {name} = ([^;]+);", _tc_source()).group(1)


def _tile(dh):
    """The tensor-core kernel's tiles at head dim `dh`, as `tc::Cfg<DH>`
    compiles them: (keys a K/V tile, Dh columns a TMA box, Dh padded to
    whole boxes, dynamic shared memory a block)."""
    tc = _tc_source()
    at, eq, other = map(int, re.search(
        r"BKV = DH == (\d+) \? (\d+) : (\d+);", tc).groups())
    below, cap = map(int, re.search(r"BW = DH < (\d+) \? DH : (\d+);",
                                    tc).groups())
    assert "DP = (DH + BW - 1) / BW * BW;" in tc
    assert "NBOX = DP / BW;" in tc
    bkv = eq if dh == at else other
    bw = dh if dh < below else cap
    dp = -(-dh // bw) * bw
    bq, stages = int(_tc_constant("BQ")), int(_tc_constant("STAGES"))
    # Q, STAGES K and V tiles of DP / BW boxes of 2 BW-byte rows, barriers,
    # 1024 bytes of slack for the swizzle's alignment
    smem = (dp // bw) * 2 * bw * (bq + 2 * stages * bkv) + 64 + 1024
    return bkv, bw, dp, smem


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_tile_table_fits_the_card(dh):
    bkv, bw, dp, smem = _tile(dh)
    assert bkv == (64 if dh == 256 else 128)
    assert bkv % 16 == 0                 # whole wgmma k16 steps over keys
    assert dh % 16 == 0                  # whole k16 steps over Dh in Q K^T
    # the boxes cover Dh; TMA zero-fills the padding (Dh 112: 16 columns)
    assert bw == min(dh, 64) and dp % bw == 0 and 0 <= dp - dh < bw
    assert dp in (16, 32, 64, 128, 256)  # an n of P V's wgmma dispatch
    # TMA's inner box is at most the swizzle span (32, 64 or 128 bytes)
    assert 2 * bw in (32, 64, 128)
    assert smem <= SMEM_PER_BLOCK
    # a consumer thread's O, S and bf16 P fragments, with room to spare
    consumer_regs = int(_tc_constant("CONSUMER_REGS"))
    assert dp // 2 + bkv // 2 + bkv // 4 <= consumer_regs - 48


def test_register_split_fits_the_block():
    # 2 consumer warpgroups and 1 producer warpgroup; setmaxnreg moves
    # registers between them inside what the launch gave the block
    assert _tc_constant("CONSUMERS") == "2"
    assert _tc_constant("THREADS") == "128 * (CONSUMERS + 1)"
    producer = int(_tc_constant("PRODUCER_REGS"))
    consumer = int(_tc_constant("CONSUMER_REGS"))
    for regs in (producer, consumer):
        assert 24 <= regs <= 256 and regs % 8 == 0
    at_launch = (REGS_PER_SM // 384) // 8 * 8          # 168 a thread
    assert 128 * producer + 256 * consumer <= 384 * at_launch


def _bytes(t, *dims):
    return tuple(t.stride(d) * t.element_size() for d in dims)


@pytest.mark.parametrize("b,h,s,dh", [(2, 8, 128, 128), (1, 4, 48, 16),
                                      (3, 2, 384, 256), (4, 32, 16, 64),
                                      (2, 4, 384, 112)])
def test_tma_geometry_of_contiguous_views(b, h, s, dh):
    q = torch.zeros((b, h, s, dh), dtype=torch.bfloat16)
    g = fa.tma_geometry("q", q)
    assert g[:4] == (dh, s, h, b)
    assert g[4:] == _bytes(q, 2, 1, 0) == (2 * dh, 2 * s * dh, 2 * h * s * dh)


@pytest.mark.parametrize("b,s,h,dh", [(4, 4096, 32, 128), (2, 128, 8, 64),
                                      (1, 48, 2, 32), (2, 16, 1, 16),
                                      (4, 4096, 32, 112)])
def test_tma_geometry_of_transposed_projections(b, s, h, dh):
    # attention_train passes (B, S, H, Dh) projections as (B, H, S, Dh) views
    q = torch.zeros((b, s, h, dh), dtype=torch.bfloat16).transpose(1, 2)
    g = fa.tma_geometry("q", q)
    assert g[:4] == (dh, s, h, b)
    assert g[4:] == _bytes(q, 2, 1, 0) == (2 * h * dh, 2 * dh, 2 * s * h * dh)
    assert all(st % 16 == 0 for st in g[4:])


@pytest.mark.parametrize("bad", ["dh_strided", "row_stride", "base"])
def test_tma_geometry_refuses_views_tma_cannot_read(bad):
    bf16 = torch.bfloat16
    if bad == "dh_strided":
        t = torch.zeros((1, 2, 16, 16), dtype=bf16).transpose(2, 3)
        match = "contiguous in Dh"
    elif bad == "row_stride":      # rows 40 bytes apart
        t = torch.zeros((1, 2, 16, 20), dtype=bf16)[..., :16]
        match = "16-byte aligned"
    else:                          # first element 2 bytes past an alignment
        t = torch.zeros(1 + 2 * 16 * 16, dtype=bf16)[1:].view(1, 2, 16, 16)
        match = "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        fa.tma_geometry("k", t)


@pytest.mark.parametrize("d", rn.ONE_READ_WIDTHS)
@pytest.mark.parametrize("element_size", [2, 4])
def test_rmsnorm_one_read_at_dense_widths(d, element_size):
    packs = rn.one_read_packs(d, element_size, aligned=True)
    assert packs > 0 and 32 * packs * (16 // element_size) == d
    assert rn.one_read_packs(d, element_size, aligned=False) == 0


@pytest.mark.parametrize("d", [1000, 33, 1536, 2056, 5120])
def test_rmsnorm_two_pass_at_other_widths(d):
    assert rn.one_read_packs(d, 2, aligned=True) == 0
    assert rn.one_read_packs(d, 4, aligned=True) == 0


def test_rmsnorm_one_read_pack_counts_match_the_compiled_kernel():
    src = (CSRC / "rmsnorm.cu").read_text()
    compiled = sorted(int(n) for n in re.findall(r"case (\d+) \* S:", src))
    assert compiled == sorted(rn.one_read_packs(d, 2, True)
                              for d in rn.ONE_READ_WIDTHS)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-8b", "granite-3-2b",
                                  "phi4-mini-3.8b", "zamba2-7b",
                                  "xlstm-1.3b", "internvl2-2b",
                                  "seamless-m4t-medium"])
def test_dense_configs_take_the_one_read_kernel(arch):
    assert rn.one_read_packs(get_arch(arch).d_model, 2, True) > 0


def test_cpu_rmsnorm_counts_no_kernel_of_either_kind():
    ops.reset_launch_counts()
    x = torch.ones((4, 2560), dtype=torch.bfloat16)
    out = ops.rmsnorm(x, torch.ones(2560, dtype=torch.bfloat16))
    assert out.shape == x.shape
    assert (ops.RMSNORM_LAUNCHES, ops.RMSNORM_ONE_READ_LAUNCHES,
            ops.RMSNORM_TWO_PASS_LAUNCHES) == (0, 0, 0)


@pytest.mark.parametrize("packs,one_read,two_pass", [(10, 1, 0), (0, 0, 1)])
def test_ops_counts_the_kernel_the_launch_reports(monkeypatch, packs,
                                                  one_read, two_pass):
    # ops takes the kernel from what the launch returns; it does not
    # decide the choice again
    x = torch.ones((4, 2560), dtype=torch.bfloat16)
    monkeypatch.setattr(ops, "_use_kernel", lambda t, backend: True)
    monkeypatch.setattr(ops, "_rmsnorm_launch",
                        lambda x, w, eps: (torch.zeros_like(x), packs))
    ops.reset_launch_counts()
    ops.rmsnorm(x, torch.ones(2560, dtype=torch.bfloat16))
    assert (ops.RMSNORM_LAUNCHES, ops.RMSNORM_ONE_READ_LAUNCHES,
            ops.RMSNORM_TWO_PASS_LAUNCHES) == (1, one_read, two_pass)
    ops.reset_launch_counts()


@pytest.mark.parametrize("call", ["rmsnorm", "rmsnorm_launch", "_two_pass"])
def test_rmsnorm_kernel_wrappers_refuse_cpu_tensors(call):
    x = torch.ones((4, 2560), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        getattr(rn, call)(x, torch.ones(2560, dtype=torch.bfloat16))
