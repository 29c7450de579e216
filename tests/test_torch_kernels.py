"""The guided_score kernels' plain PyTorch versions against the Pallas
kernels (interpret mode, as tests/test_kernels.py runs them).

The port's wrappers run the plain version on CPU tensors, which is what
these tests reach; the CUDA kernels are held to the same plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py). Tolerance: rows 0-2
(Global/Local/Rank) within rtol 1e-5 / atol 1e-5, the bound the reference
holds its own kernel to against its oracle (XLA contracts the combines
into fused multiply-adds, the port rounds each product, so low bits may
differ); rows 3-4 (the masks) identical. The reference's kernels return
those five rows; the port's 6th, the postings per slot, is held to a
count made here from the offsets."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.guided_score import (guided_score_chunk as jax_chunk,
                                        guided_score_tile as jax_tile)
from repro_torch.kernels import guided_score as gs


def _tile_inputs(rng, nq, p, tile_size, density=0.5):
    """The inputs tests/test_kernels.py draws: sorted distinct offsets in a
    prefix of each run, -1 padding after it."""
    n_valid = int(p * density)
    offs = np.full((nq, p), -1, np.int32)
    for i in range(nq):
        offs[i, :n_valid] = np.sort(
            rng.choice(tile_size, size=n_valid, replace=False))
    wb = (rng.random((nq, p)) * 3).astype(np.float32) * (offs >= 0)
    wl = (rng.random((nq, p)) * 5).astype(np.float32) * (offs >= 0)
    return offs, wb, wl


def _assert_rows_match(ref, port):
    """Rows 0-4 of the port's six against the reference's five."""
    ref = np.asarray(ref)
    port = port.numpy()
    assert ref.shape[-2] == 5
    assert port.shape == ref.shape[:-2] + (6,) + ref.shape[-1:]
    port = port[..., :5, :]
    np.testing.assert_array_equal(ref[..., 3:, :], port[..., 3:, :])
    np.testing.assert_allclose(ref[..., :3, :], port[..., :3, :],
                               rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tile_case(nq, p, tile_size, block_s, seed, coefs, th_lo,
               ess_rate=0.5):
    rng = np.random.default_rng(seed)
    offs, wb, wl = _tile_inputs(rng, nq, p, tile_size)
    ess = (rng.random(nq) < ess_rate).astype(np.float32)
    pbeta = np.cumsum(rng.random(nq)).astype(np.float32)
    ref = jax_tile(jnp.asarray(offs), jnp.asarray(wb), jnp.asarray(wl),
                   jnp.asarray(ess), jnp.asarray(pbeta), jnp.float32(th_lo),
                   *(jnp.float32(c) for c in coefs), tile_size=tile_size,
                   block_s=block_s)
    port = gs.guided_score_tile(
        _t(offs[None]), _t(wb[None]), _t(wl[None]), _t(ess[None]),
        _t(pbeta[None]), torch.tensor([th_lo], dtype=torch.float32),
        *coefs, tile_size=tile_size)
    _assert_rows_match(ref, port[0])


@pytest.mark.parametrize("nq,p,tile_size,block_s", [
    (4, 64, 256, 128), (8, 128, 512, 512), (16, 128, 1024, 256),
    (5, 96, 384, 128),  # non-power-of-two nq/p
])
def test_tile_plain_matches_pallas(nq, p, tile_size, block_s):
    _tile_case(nq, p, tile_size, block_s, nq * 1000 + p, (1.0, 0.3, 0.05),
               2.0)


@pytest.mark.parametrize("alpha,beta,gamma,th_lo", [
    (0.0, 0.0, 0.0, -np.inf), (1.0, 1.0, 0.05, 0.5), (0.7, 0.2, 0.0, 5.0)])
def test_tile_plain_param_sweep(alpha, beta, gamma, th_lo):
    _tile_case(8, 64, 256, 128, 0, (alpha, beta, gamma), th_lo,
               ess_rate=0.6)


@pytest.mark.parametrize("n_chunk,nq,p,tile_size,block_s", [
    (4, 8, 64, 256, 128), (3, 5, 96, 384, 128), (2, 8, 128, 512, 512)])
def test_chunk_plain_matches_pallas(n_chunk, nq, p, tile_size, block_s):
    """Batched over queries: each row's chunk equals the reference's
    per-query chunk call, with the row's own th_lo; skipped tiles zero."""
    rng = np.random.default_rng(n_chunk * 100 + nq)
    b = 2
    tiles = [[_tile_inputs(rng, nq, p, tile_size) for _ in range(n_chunk)]
             for _ in range(b)]
    offs, wb, wl = (np.stack([np.stack([t[j] for t in row]) for row in tiles])
                    for j in range(3))
    ess = (rng.random((b, n_chunk, nq)) < 0.5).astype(np.float32)
    pbeta = np.cumsum(rng.random((b, n_chunk, nq)), axis=-1).astype(
        np.float32)
    skip = np.array([[(i + r) % 2 for i in range(n_chunk)] for r in range(b)],
                    np.int32)
    th = np.array([2.0, 0.5], np.float32)
    coefs = (1.0, 0.3, 0.05)
    port = gs.guided_score_chunk(_t(offs), _t(wb), _t(wl), _t(ess),
                                 _t(pbeta), _t(skip), _t(th), *coefs,
                                 tile_size=tile_size)
    assert port.shape == (b, n_chunk, 6, tile_size)
    for r in range(b):
        ref = jax_chunk(jnp.asarray(offs[r]), jnp.asarray(wb[r]),
                        jnp.asarray(wl[r]), jnp.asarray(ess[r]),
                        jnp.asarray(pbeta[r]), jnp.asarray(skip[r]),
                        jnp.float32(th[r]),
                        *(jnp.float32(c) for c in coefs),
                        tile_size=tile_size, block_s=block_s)
        _assert_rows_match(ref, port[r])
        assert (port[r][skip[r] != 0] == 0).all()


def test_chunk_all_skipped_is_zero():
    rng = np.random.default_rng(0)
    offs, wb, wl = _tile_inputs(rng, 4, 32, 128)
    offs, wb, wl = (np.stack([np.stack([a, a])] * 2) for a in (offs, wb, wl))
    args = (_t(offs), _t(wb), _t(wl), torch.ones(2, 2, 4),
            torch.ones(2, 2, 4), torch.ones(2, 2, dtype=torch.int32),
            torch.zeros(2), 1.0, 0.3, 0.05)
    ref = jax_chunk(jnp.asarray(offs[0]), jnp.asarray(wb[0]),
                    jnp.asarray(wl[0]), jnp.ones((2, 4), jnp.float32),
                    jnp.ones((2, 4), jnp.float32), jnp.ones(2, jnp.int32),
                    jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.3),
                    jnp.float32(0.05), tile_size=128)
    port = gs.guided_score_chunk(*args, tile_size=128)
    np.testing.assert_array_equal(np.asarray(ref), 0.0)
    np.testing.assert_array_equal(port.numpy(), 0.0)


def _slot_counts(offs, tile_size):
    """Postings per slot, counted posting by posting in numpy:
    [..., Nq, P] -> [..., S]."""
    lead = offs.shape[:-2]
    flat = offs.reshape(-1, offs.shape[-2] * offs.shape[-1])
    cnt = np.zeros((flat.shape[0], tile_size), np.float32)
    for r, row in enumerate(flat):
        np.add.at(cnt[r], row[row >= 0], 1.0)
    return cnt.reshape(lead + (tile_size,))


@pytest.mark.parametrize("nq,p,tile_size", [(6, 40, 128), (33, 96, 384)])
def test_row5_counts_postings_per_slot(nq, p, tile_size):
    """Row 5 of both plain scorers is the valid postings per slot over all
    Nq terms: runs of every length ending in -1 (one empty, one of exactly
    P), the pad term repeated in the last query slots at weight 0 (each
    slot counts its posting), and zero on a skipped tile."""
    rng = np.random.default_rng(nq)
    b, c = 3, 4
    offs = np.full((b, c, nq, p), -1, np.int32)
    for idx in np.ndindex(b, c, nq):
        n = int(rng.integers(0, p + 1))
        offs[idx][:n] = np.sort(rng.choice(tile_size, n, replace=False))
    offs[0, 0, 0] = -1                                   # an empty run
    offs[0, 1, 0] = np.sort(rng.choice(tile_size, p, replace=False))
    offs[..., -3:, :] = offs[..., :1, :]                 # the pad term
    wb = (rng.random(offs.shape) * 3).astype(np.float32) * (offs >= 0)
    wl = (rng.random(offs.shape) * 5).astype(np.float32) * (offs >= 0)
    wb[..., -3:, :] = 0.0
    wl[..., -3:, :] = 0.0
    ess = (rng.random((b, c, nq)) < 0.5).astype(np.float32)
    pb = np.cumsum(rng.random((b, c, nq)), -1).astype(np.float32)
    skip = (rng.random((b, c)) < 0.4).astype(np.int32)
    skip[0, :2], skip[1, 0] = 0, 1
    th = (rng.random(b) * 3).astype(np.float32)
    want = _slot_counts(offs, tile_size)
    assert want.max() >= 4                   # the pad term's slots
    chunk = gs.guided_score_chunk_plain(
        _t(offs), _t(wb), _t(wl), _t(ess), _t(pb), _t(skip), _t(th), 1.0,
        0.3, 0.05, tile_size=tile_size)[..., 5, :].numpy()
    np.testing.assert_array_equal(chunk[skip == 0], want[skip == 0])
    assert not chunk[skip != 0].any()
    tile = gs.guided_score_tile_plain(
        _t(offs[:, 1]), _t(wb[:, 1]), _t(wl[:, 1]), _t(ess[:, 1]),
        _t(pb[:, 1]), _t(th), 1.0, 0.3, 0.05,
        tile_size=tile_size)[..., 5, :].numpy()
    np.testing.assert_array_equal(tile, want[:, 1])


def test_cpu_tensors_run_the_plain_version_uncounted():
    """Dispatch is by device: CPU tensors never reach the kernel or its
    launch count; the chunk form equals the tile form on live tiles."""
    gs.reset_launches()
    rng = np.random.default_rng(1)
    offs, wb, wl = _tile_inputs(rng, 6, 40, 128)
    ess = (rng.random((1, 6)) < 0.5).astype(np.float32)
    pb = np.cumsum(rng.random((1, 6)), -1).astype(np.float32)
    th = torch.tensor([1.0])
    tile = gs.guided_score_tile(_t(offs[None]), _t(wb[None]), _t(wl[None]),
                                _t(ess), _t(pb), th, 1.0, 0.3, 0.05,
                                tile_size=128)
    chunk = gs.guided_score_chunk(_t(offs[None, None]), _t(wb[None, None]),
                                  _t(wl[None, None]), _t(ess[:, None]),
                                  _t(pb[:, None]),
                                  torch.zeros(1, 1, dtype=torch.int32), th,
                                  1.0, 0.3, 0.05, tile_size=128)
    torch.testing.assert_close(tile, chunk[:, 0], rtol=0, atol=0)
    assert gs.guided_score_tile.launches == 0
    assert gs.guided_score_chunk.launches == 0
    with pytest.raises(ValueError, match="device"):
        gs.guided_score_tile(_t(offs[None]).to("meta"), None, None, None,
                             None, th, 1.0, 0.3, 0.05, tile_size=128)


@pytest.mark.parametrize("nq,tile_size", [
    (1, 64), (5, 100), (16, 2048), (33, 2000), (64, 1500), (64, 2048),
    (16, 1000), (7, 384)])
def test_tile_lane_width_covers_and_fits(nq, tile_size):
    """The tile kernels' lane blocks cover every slot once, and a block's
    shared memory (fp32 and q8) fits the H100's opt-in limit at Nq <= 64."""
    width = gs.tile_lane_width(nq, tile_size)
    n_blocks = -(-tile_size // width)
    assert 1 <= width <= tile_size
    assert (n_blocks - 1) * width < tile_size <= n_blocks * width
    for q8 in (False, True):
        assert gs.tile_smem_bytes(nq, width, q8) <= 227 * 1024


def test_tile_grid_fills_the_card_on_the_main_path():
    """At the main path's [B=16, Nq=16] tiles of S = 2048 slots the tile
    grid has at least one block per SM of the H100 (132); the chunk grid
    of a [16, 8] chunk at ``chunk_lane_width`` fills the card (at least
    ``RESIDENT_BLOCKS``) within two waves, where the tile kernels' lane
    width would take about eight."""
    width = gs.tile_lane_width(16, 2048)
    assert 16 * -(-2048 // width) >= 132
    chunk_grid = 16 * 8 * -(-2048 // gs.chunk_lane_width(16, 2048, 128))
    assert gs.RESIDENT_BLOCKS <= chunk_grid <= 2 * gs.RESIDENT_BLOCKS
    assert 16 * 8 * -(-2048 // width) > 2 * gs.RESIDENT_BLOCKS


@pytest.mark.parametrize("nq,tile_size,n_tiles", [
    (16, 2048, 128), (16, 2048, 16), (16, 2048, 72), (33, 2000, 72),
    (64, 1500, 72), (64, 2048, 4096), (16, 384, 288), (16, 300, 200),
    (5, 100, 2), (1, 64, 1)])
def test_chunk_lane_width_covers_and_fits(nq, tile_size, n_tiles):
    """The chunk kernels' lane blocks cover every slot once, a block's
    shared memory (fp32 and q8) fits the H100's opt-in limit at Nq <= 64,
    and a chunk is never cut finer than one tile per query would be."""
    width = gs.chunk_lane_width(nq, tile_size, n_tiles)
    n_blocks = -(-tile_size // width)
    assert 1 <= width <= tile_size
    assert (n_blocks - 1) * width < tile_size <= n_blocks * width
    assert gs.tile_lane_width(nq, tile_size) <= width <= gs.CHUNK_LANE_WIDTH
    for q8 in (False, True):
        assert gs.tile_smem_bytes(nq, width, q8) <= 227 * 1024


def test_chunk_grid_is_about_two_waves_on_the_main_path():
    """At the main path's [B=16, C=8, Nq=16] chunk of S = 2048 slots the
    chunk grid runs in at most about two waves of the stated residency
    (two 512-thread blocks per SM, whose shared memory fits an SM's 228
    KB together), where the tile kernels' lane width would give eight; a
    chunk too small to fill the card keeps the tile kernels' width."""
    width = gs.chunk_lane_width(16, 2048, 16 * 8)
    blocks = 16 * 8 * -(-2048 // width)
    assert width == gs.CHUNK_LANE_WIDTH
    assert gs.RESIDENT_BLOCKS <= blocks <= 2 * gs.RESIDENT_BLOCKS
    assert 2 * gs.tile_smem_bytes(16, width, True) <= 228 * 1024
    assert 16 * 8 * -(-2048 // gs.tile_lane_width(16, 2048)) \
        > 7 * gs.RESIDENT_BLOCKS
    assert gs.chunk_lane_width(16, 2048, 16) == gs.tile_lane_width(16, 2048)


def _raw_args(q8: bool, b: int, c: int | None, nq: int, p: int):
    """Zero inputs of a kernel wrapper's shapes (``c`` None: one tile per
    query), on the CPU."""
    lead = (b,) if c is None else (b, c)
    z = torch.zeros
    if q8:
        rows = (z(lead + (nq, 3), dtype=torch.int32),
                z(lead + (nq, p), dtype=torch.uint8),
                z(lead + (nq, p), dtype=torch.uint8),
                z(lead + (3, nq), dtype=torch.int32), z(lead + (4, nq)),
                z(b, nq), z(b, nq))
    else:
        rows = (z(lead + (nq, p), dtype=torch.int32), z(lead + (nq, p)),
                z(lead + (nq, p)))
    skip = None if c is None else z(b, c, dtype=torch.int32)
    return (*rows, z(lead + (nq,)), z(lead + (nq,)), skip, z(b), 1.0, 0.3,
            0.05)


@pytest.mark.parametrize("q8", [False, True], ids=["fp32", "q8"])
@pytest.mark.parametrize("form,b,c", [
    ("chunk", 16, 8), ("chunk", 2, 3), ("tile", 16, None)])
def test_launchers_route_to_the_tile_source(monkeypatch, q8, form, b, c):
    """Both forms of both indexes launch from ``guided_score_tile.cu``: the
    chunk launchers at the chunk lane width (512 at the main path's [16,
    8] chunk, the tile width for a small chunk), the tile launchers at the
    tile lane width."""
    calls = []

    def record(source, fn_name, inputs, coefs, out, sizes, block_s):
        calls.append((source, fn_name, sizes, block_s))
        return out
    monkeypatch.setattr(gs, "_call", record)
    nq, p, s = 16, 4, 2048
    fn_name = f"guided_score_{form}{'_q' if q8 else ''}_launch"
    launch = gs._launch_q if q8 else gs._launch
    out = launch(fn_name, *_raw_args(q8, b, c, nq, p), b=b, c=c or 1,
                 tile_size=s)
    width = (gs.chunk_lane_width(nq, s, b * c) if form == "chunk"
             else gs.tile_lane_width(nq, s))
    assert calls == [("guided_score_tile.cu", fn_name,
                      (b, c or 1, nq) + ((3,) if q8 else ()) + (p, s),
                      width)]
    assert width == (512 if (form, b) == ("chunk", 16) else 128)
    assert out.shape == (b,) + ((c,) if c else ()) + (6, s)


def test_load_builds_once_across_threads(monkeypatch):
    """Executor threads can make a source's first launch at the same time:
    ``load`` builds (``build_all``) once and every thread gets the one
    library. ``build_all`` is a slow stub here (no nvcc on the CPU)."""
    import threading
    import time

    from repro_torch.kernels import build
    builds = []

    def slow_build_all():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        for source in build.SOURCES:
            build._libs[source] = f"lib:{source}"
        return build.build_log
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_all", slow_build_all)
    start = threading.Barrier(8)
    got = []

    def first_launch():
        start.wait(timeout=10)
        got.append(build.load("guided_score_tile.cu"))
    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1
    assert got == ["lib:guided_score_tile.cu"] * 8
