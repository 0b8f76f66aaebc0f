"""The paged-decode kernel's split of each row's pages over CTAs
(``csrc/paged_decode.cu``), on the CPU: the host's split rule
(``ops.paged_splits``), the cut of a row's table entries into splits
(``ref.split_pages``), and a plain emulation of the kernel's partial-and-
merge arithmetic (``ref.paged_decode_split_ref``) held against the JAX
package's paged-decode kernel (interpret mode) and its reference.

Tolerance: float32, where the emulation differs from the JAX functions
only in summation order and in taking exp as 2^(x log2 e): rtol = atol =
1e-5, as ``tests/test_torch_attention.py`` holds the plain version.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_decode_attention as j_paged
from repro.kernels.paged_decode.ref import (
    paged_decode_attention_ref as j_paged_ref)
from repro_torch.kernels import launches
from repro_torch.kernels.paged_decode import ops
from repro_torch.kernels.paged_decode.ops import (paged_decode_attention,
                                                  paged_splits)
from repro_torch.kernels.paged_decode.ref import (paged_decode_attention_ref,
                                                  paged_decode_split_ref,
                                                  split_pages)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# llama3-8b's decode on an H100 (132 SMs): B 4, KVH 8, 130 pages a row
PAGED_SPLIT = (4, 8, 130, 132)


@pytest.mark.parametrize("bsz,kvh,pps,sms", [
    PAGED_SPLIT, (1, 1, 130, 132), (1, 8, 1, 132), (4, 8, 3, 132),
    (64, 8, 130, 132), (400, 8, 9, 132), (2, 2, 9, 1), (3, 5, 7, 16),
    (1, 1, 10 ** 6, 10 ** 4)])
def test_paged_splits_bounds(bsz, kvh, pps, sms):
    s = paged_splits(bsz, kvh, pps, sms)
    assert 1 <= s <= min(pps, ops.MAX_SPLITS)
    # one wave: the CTAs fit the card's SMs at CTAS_PER_SM each, unless
    # B x KVH alone passes that, and then there is one split
    if bsz * kvh >= ops.CTAS_PER_SM * sms:
        assert s == 1
    else:
        assert s * bsz * kvh <= ops.CTAS_PER_SM * sms
    if s < min(pps, ops.MAX_SPLITS):   # not cut by a bound: the card is full
        assert (s + 1) * bsz * kvh > ops.CTAS_PER_SM * sms


def test_paged_splits_at_llama3_8b_decode():
    s = paged_splits(*PAGED_SPLIT)
    assert 8 <= s <= 16 and 256 <= s * 4 * 8 <= 512


@pytest.mark.parametrize("pps", [1, 2, 3, 9, 16, 130])
def test_split_pages_cover_every_page_once(pps):
    for splits in range(1, pps + 1):
        ranges = split_pages(pps, splits)
        assert len(ranges) == splits
        assert [p for lo, hi in ranges for p in range(lo, hi)] == list(
            range(pps))
        assert all(hi > lo for lo, hi in ranges)          # none without pages
        sizes = {hi - lo for lo, hi in ranges}
        assert max(sizes) - min(sizes) <= 1


def _inputs(b, kvh, g, dh, pages, page, pps, lengths, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, kvh, g, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.integers(0, pages, (b, pps)).astype(np.int32),   # repeats
            np.asarray(lengths, dtype=np.int32))


# (B, KVH, G, dh, pages, page, pps, lengths): rows of length 0 and 1, one
# ending on a split's last position and one just past it (for S = 2 and
# 7), full rows; short rows leave most splits of S = 7 and S = pps empty
SPLIT_CASES = [
    (3, 2, 4, 16, 12, 8, 7, [0, 1, 56]),
    (4, 2, 2, 32, 40, 4, 14, [16, 17, 28, 29]),
    (2, 1, 1, 16, 9, 16, 9, [3 * 16, 3 * 16 + 1]),
    (3, 2, 8, 16, 20, 8, 10, [5 * 8, 0, 80]),
    (2, 2, 4, 64, 30, 16, 15, [1, 2 * 16 + 1]),
]


@functools.lru_cache(maxsize=None)
def _jax_outputs(case):
    """The JAX kernel's (interpret mode) and reference's outputs for
    ``SPLIT_CASES[case]``, computed once for its four split counts."""
    b, kvh, g, dh, pages, page, pps, lengths = SPLIT_CASES[case]
    ins = _inputs(b, kvh, g, dh, pages, page, pps, lengths, seed=pps)
    j_ins = list(map(jnp.asarray, ins))
    scale = 1 / dh ** 0.5
    return ins, [np.asarray(j_paged(*j_ins, interpret=True)),
                 np.asarray(j_paged_ref(*j_ins, scale=scale))]


@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
@pytest.mark.parametrize("splits", ["1", "2", "7", "pps"])
def test_split_ref_equals_jax_kernel_and_oracle(case, splits):
    b, kvh, g, dh, _, _, pps, _ = SPLIT_CASES[case]
    s = pps if splits == "pps" else min(int(splits), pps)
    ins, wants = _jax_outputs(case)
    got = paged_decode_split_ref(*map(torch.from_numpy, ins),
                                 scale=1 / dh ** 0.5, splits=s).numpy()
    assert got.dtype == np.float32 and got.shape == (b, kvh, g, dh)
    for want in wants:
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_split_ref_leaves_splits_empty():
    # a row of length 1 among 130 pages: 129 of S = 130 splits see no
    # position, and the merge must give that position's V exactly
    b, kvh, g, dh, page, pps = 2, 1, 4, 16, 4, 130
    ins = _inputs(b, kvh, g, dh, b * pps, page, pps, [1, 0], seed=3)
    t = list(map(torch.from_numpy, ins))
    for splits in (2, 7, pps):
        got = paged_decode_split_ref(*t, scale=0.25, splits=splits)
        v0 = t[2][0, t[3][0, 0]][0]                  # position 0 of row 0
        np.testing.assert_allclose(got[0, 0].numpy(),
                                   v0.expand(g, dh).numpy(), **F32_TOL)
        # row 1 (length 0): the mean of V over all its positions
        rows = t[2][0, t[3][1].long()].reshape(-1, dh)
        np.testing.assert_allclose(got[1, 0].numpy(),
                                   rows.mean(0).expand(g, dh).numpy(),
                                   **F32_TOL)


def test_split_ref_clamps_lengths_as_the_kernel():
    # lengths past the table's positions and below 0 are clamped to
    # [0, pps * page]: the plain version masks the same positions
    ins = list(_inputs(3, 2, 2, 16, 12, 8, 3, [0, 0, 0], seed=4))
    ins[4] = np.array([-3, 24, 1000], dtype=np.int32)
    t = list(map(torch.from_numpy, ins))
    clamped = t[:4] + [torch.tensor([0, 24, 24], dtype=torch.int32)]
    want = paged_decode_attention_ref(*clamped, scale=0.25)
    for splits in (1, 2, 3):
        got = paged_decode_split_ref(*t, scale=0.25, splits=splits)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_split_ref_bfloat16_rounds_once():
    # bfloat16 in, float32 arithmetic, one rounding of the float32 result
    ins = _inputs(2, 2, 4, 64, 16, 8, 6, [5, 48], seed=5)
    t = [torch.from_numpy(x) for x in ins]
    bf = [x.bfloat16() for x in t[:3]] + t[3:]
    got = paged_decode_split_ref(*bf, scale=0.125, splits=4)
    want = paged_decode_split_ref(*[x.float() for x in bf[:3]] + bf[3:],
                                  scale=0.125, splits=4)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.bfloat16())


def test_wrapper_on_cpu_runs_the_plain_version_and_no_split():
    ins = list(map(torch.from_numpy,
                   _inputs(2, 2, 4, 16, 12, 8, 3, [7, 24], seed=6)))
    before = launches["paged_decode"]
    got = paged_decode_attention(*ins)
    assert torch.equal(got, paged_decode_attention_ref(*ins, scale=0.25))
    assert launches["paged_decode"] == before and not ops._WORKSPACES
