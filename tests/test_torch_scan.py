"""pinot_tpu_torch masked-sum scans against the JAX package's Pallas kernels.

The port's plain PyTorch versions (what its wrappers run for CPU tensors) are
held against `masked_sums_pallas` / `masked_sums_pallas_fused` in Pallas
interpret mode, against `masked_sums_xla`, and against numpy truth, on inputs
made from a seed with numpy. Tolerance: rel 1e-4 on sums (the Pallas test's
own), counts equal. The CUDA kernels themselves run only on a card
(`chip_smoke.py` and tests/test_torch_kernels_gpu.py)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pinot_tpu.engine.pallas_scan import (masked_sums_pallas,  # noqa: E402
                                          masked_sums_pallas_fused, masked_sums_xla)
from pinot_tpu_torch.engine import scan  # noqa: E402

N = 1 << 16
BLOCK = 1 << 13
I32_MIN, I32_MAX = scan.INT32_MIN, scan.INT32_MAX
Q11_BANDS = [(336, 671), (1, 3), (0, 23)]


def _data(n=N, seed=11):
    rng = np.random.default_rng(seed)
    return {
        "od": rng.integers(0, 2353, n).astype(np.int32),   # pad id 2352 included
        "disc": rng.integers(0, 11, n).astype(np.int32),
        "qty": rng.integers(0, 50, n).astype(np.int32),
        "price": rng.uniform(1, 10000, n).astype(np.float32),
        "rev": rng.uniform(-100, 60000, n).astype(np.float32),
        "d8": rng.integers(0, 256, n).astype(np.uint8),
        "d16": rng.integers(0, 1 << 16, n).astype(np.uint16),
    }


def _np_mask(cols, bands):
    m = np.ones(len(cols[0]), dtype=bool)
    for c, (lo, hi) in zip(cols, bands):
        m &= (c >= lo) & (c <= hi)
    return m


def _port(cols, bands, rows):
    sums, count = scan.masked_sums_plain([torch.from_numpy(c) for c in cols], bands,
                                         [torch.from_numpy(r) for r in rows])
    return sums.numpy(), int(count)


def _port_fused(cols, bands, for_rows):
    sums, count = scan.masked_sums_fused_plain(
        [torch.from_numpy(c) for c in cols], bands,
        [(b, torch.from_numpy(d)) for b, d in for_rows])
    return sums.numpy(), int(count)


def _check(sums, count, want, rtol=1e-4):
    assert count == int(round(float(want[-1]))), (count, want)
    np.testing.assert_allclose(sums, np.asarray(want[:-1], dtype=np.float64), rtol=rtol)


@pytest.mark.parametrize("bands", [
    Q11_BANDS,
    [(I32_MIN, 671), (1, I32_MAX), (I32_MIN, 23)],   # one-sided bands
    [(0, 2351), (0, 10), (0, 49)],                    # everything but padding ids
], ids=["q11", "one_sided", "wide"])
def test_masked_sums_plain_matches_pallas_xla_numpy(bands):
    d = _data()
    cols = [d["od"], d["disc"], d["qty"]]
    rows = [d["price"], d["rev"]]
    sums, count = _port(cols, bands, rows)
    jcols = [jnp.asarray(c) for c in cols]
    jrows = [jnp.asarray(r) for r in rows]
    _check(sums, count, np.asarray(masked_sums_pallas(jcols, bands, jrows,
                                                      block_rows=BLOCK, interpret=True)))
    _check(sums, count, np.asarray(masked_sums_xla(jcols, bands, jrows)))
    m = _np_mask(cols, bands)
    assert count == int(m.sum())
    np.testing.assert_allclose(sums, [r[m].astype(np.float64).sum() for r in rows], rtol=1e-5)


def test_masked_sums_plain_empty_mask():
    d = _data()
    cols = [d["od"], d["disc"], d["qty"]]
    empty = [(1, 0)] * 3
    sums, count = _port(cols, empty, [d["price"]])
    assert count == 0 and sums.tolist() == [0.0]
    pallas = np.asarray(masked_sums_pallas([jnp.asarray(c) for c in cols], empty,
                                           [jnp.asarray(d["price"])], block_rows=BLOCK,
                                           interpret=True))
    assert np.allclose(pallas, 0.0)


@pytest.mark.parametrize("delta, base", [("d8", 1.0), ("d8", -37.0), ("d16", -5000.0),
                                         ("d16", 123.0)])
def test_masked_sums_fused_plain_matches_pallas_and_decoded(delta, base):
    d = _data()
    cols = [d["od"], d["disc"]]
    bands = Q11_BANDS[:2]
    deltas = d[delta]
    sums, count = _port_fused(cols, bands, [(base, deltas), (2.0, d["d8"])])
    # the JAX fused kernel has no reference test: expected values come from the
    # decoded columns, through the XLA reference and numpy
    decoded = [deltas.astype(np.float32) + np.float32(base),
               d["d8"].astype(np.float32) + np.float32(2.0)]
    jcols = [jnp.asarray(c) for c in cols]
    _check(sums, count, np.asarray(masked_sums_xla(jcols, bands,
                                                   [jnp.asarray(x) for x in decoded])))
    _check(sums, count, np.asarray(masked_sums_pallas_fused(
        jcols, bands, [(base, jnp.asarray(deltas)), (2.0, jnp.asarray(d["d8"]))],
        block_rows=BLOCK, interpret=True)))
    m = _np_mask(cols, bands)
    want = [(deltas[m].astype(np.float64) + base).sum(),
            (d["d8"][m].astype(np.float64) + 2.0).sum()]
    assert count == int(m.sum())
    np.testing.assert_allclose(sums, want, rtol=1e-5)


@pytest.mark.parametrize("n", [1000, N - 12345, 3])
def test_ragged_rows_match_numpy(n):
    d = _data(n=n, seed=n)
    cols = [d["od"], d["disc"], d["qty"]]
    sums, count = _port(cols, Q11_BANDS, [d["price"]])
    m = _np_mask(cols, Q11_BANDS)
    assert count == int(m.sum())
    np.testing.assert_allclose(sums, [d["price"][m].astype(np.float64).sum()],
                               rtol=1e-5, atol=1e-3)
    fsums, fcount = _port_fused(cols[:2], Q11_BANDS[:2], [(7.0, d["d16"])])
    m2 = _np_mask(cols[:2], Q11_BANDS[:2])
    assert fcount == int(m2.sum())
    np.testing.assert_allclose(fsums, [(d["d16"][m2].astype(np.float64) + 7).sum()],
                               rtol=1e-5, atol=1e-3)


def test_wrappers_on_cpu_tensors_run_the_plain_versions_uncounted():
    d = _data(n=4096)
    cols = [torch.from_numpy(d["od"]), torch.from_numpy(d["disc"])]
    rows = [torch.from_numpy(d["price"])]
    before = (scan.masked_sums.launches, scan.masked_sums_fused.launches)
    got = scan.masked_sums(cols, Q11_BANDS[:2], rows)
    want = scan.masked_sums_plain(cols, Q11_BANDS[:2], rows)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    packed = scan.masked_sums_packed(cols, Q11_BANDS[:2], rows)
    assert packed.dtype == torch.float32 and packed.shape == (2,)
    assert float(packed[1]) == float(want[1])
    fused = scan.masked_sums_fused_packed(cols, Q11_BANDS[:2],
                                          [(1.0, torch.from_numpy(d["d8"]))])
    assert fused.shape == (2,)
    assert (scan.masked_sums.launches, scan.masked_sums_fused.launches) == before


def test_count_is_exact_int64():
    d = _data(n=4096)
    sums, count = scan.masked_sums_plain([torch.from_numpy(d["qty"])], [(0, 49)], [])
    assert count.dtype == torch.int64 and int(count) == 4096
    assert sums.shape == (0,)


# the shape csrc/masked_sums.cu reports through pinot_masked_sums_config
SHAPE = scan.KernelShape(stages=4, ring_bytes=128 * 1024, group_rows=16, ticket_slots=1024)


@pytest.mark.parametrize("itemsize", [4, 1, 2], ids=["f32", "u8", "u16"])
def test_scan_plan_stages_are_whole_groups_within_the_ring(itemsize):
    stages, ring, group = SHAPE.stages, SHAPE.ring_bytes, SHAPE.group_rows
    for n_mask in range(scan.MAX_MASK_COLS + 1):
        for n_sums in range(scan.MAX_SUMS + 1):
            if n_mask + n_sums == 0:
                continue
            bytes_per_row = 4 * n_mask + itemsize * n_sums
            for n in (0, 17, 5000, 1 << 21, 1 << 30):
                plan = scan.scan_plan(n, n_mask, n_sums, itemsize, 132, SHAPE)
                rows = plan.rows_per_stage
                assert rows > 0 and rows % group == 0, (n_mask, n_sums, n, rows)
                # every column's tile is a whole number of 16-byte units
                assert rows * itemsize % 16 == 0 and rows * 4 % 16 == 0
                assert stages * rows * bytes_per_row <= ring
                # a block's range spans at least `stages` tiles while the ring has room
                block_rows = -(-(n // 16) // plan.grid) * 16
                if stages * (rows + 16) * bytes_per_row <= ring:
                    assert stages * rows >= block_rows, (n_mask, n_sums, n)
            # a segment of the main path fills the card; a large one fills the ring
            assert scan.scan_plan(1 << 21, n_mask, n_sums, itemsize, 132, SHAPE).grid == 132
            rows = scan.scan_plan(1 << 30, n_mask, n_sums, itemsize, 132, SHAPE).rows_per_stage
            assert stages * (rows + group) * bytes_per_row > ring


def test_scan_plan_grid_and_stage_rows():
    assert scan.scan_plan(1 << 21, 3, 1, 4, 132, SHAPE).rows_per_stage == 2048   # Q1.1
    assert scan.scan_plan(1 << 21, 2, 1, 1, 132, SHAPE).rows_per_stage == 3632   # FOR
    block = scan.MIN_BLOCK_ROWS
    for n, want in [(0, 1), (1, 1), (15, 1), (16, 1), (block + 15, 1), (2 * block, 2),
                    (5 * block + 100, 5), (1 << 21, 132), ((1 << 21) - 3, 132)]:
        assert scan.scan_plan(n, 3, 1, 4, 132, SHAPE).grid == want, n
    with pytest.raises(ValueError):
        scan.scan_plan(10, 0, 0, 4, 132, SHAPE)


def test_answer_buffer_reaches_the_host_in_one_piece():
    out = torch.zeros(1 + 2, dtype=torch.int64)   # count, then 3 f32 sums (+ pad)
    sums, count = scan.answer_views(out, 3)
    count.fill_(123456789012)
    sums.copy_(torch.tensor([1.5, -2.25, 3e9]))
    host_sums, host_count = scan.answer_to_host(out, 3)
    assert host_count == 123456789012
    np.testing.assert_array_equal(host_sums, np.array([1.5, -2.25, 3e9], dtype=np.float32))
    assert host_sums.dtype == np.float32
    host_sums, host_count = scan.answer_to_host(torch.zeros(1, dtype=torch.int64), 0)
    assert host_count == 0 and host_sums.shape == (0,)


def test_answers_on_the_cpu_hold_the_plain_versions():
    d = _data(n=5000)
    cols = [torch.from_numpy(d[k]) for k in ("od", "disc", "qty")]
    rows = [torch.from_numpy(d["price"]), torch.from_numpy(d["price"]) * 2]
    before = (scan.masked_sums.launches, scan.masked_sums_fused.launches)
    sums, count = scan.answer_views(scan.masked_sums_answer(cols, Q11_BANDS, rows), 2)
    ps, pc = scan.masked_sums_plain(cols, Q11_BANDS, rows)
    assert torch.equal(sums, ps) and int(count) == int(pc)
    for_rows = [(1.0, torch.from_numpy(d["d8"]))]
    got = scan.answer_to_host(
        scan.masked_sums_fused_answer(cols[:2], Q11_BANDS[:2], for_rows), 1)
    ps, pc = scan.masked_sums_fused_plain(cols[:2], Q11_BANDS[:2], for_rows)
    np.testing.assert_array_equal(got[0], ps.numpy())
    assert got[1] == int(pc)
    assert (scan.masked_sums.launches, scan.masked_sums_fused.launches) == before


def test_ptxas_usage_reads_registers_smem_and_spills():
    from pinot_tpu_torch.engine import cuda_lib
    log = ("ptxas info    : Compiling entry function '_Z3fooILi1EEvv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z3fooILi1EEvv\n"
           "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 72 registers, used 1 barriers, 904 bytes smem, "
           "624 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
           "ptxas info    : Used 12 registers, 388 bytes cmem[0]\n")
    assert cuda_lib.ptxas_usage(log) == {
        "_Z3fooILi1EEvv": {"stack_bytes": 16, "spill_store_bytes": 8,
                           "spill_load_bytes": 4, "registers": 72,
                           "static_smem_bytes": 904},
        "_Z3barv": {"registers": 12, "static_smem_bytes": 0},
    }
