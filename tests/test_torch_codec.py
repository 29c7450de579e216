"""The port's numpy codec (``repro_torch.index.codec``) against the JAX
package's (``repro.index.codec``): the same inputs, drawn from fixed seeds,
give byte-equal outputs (values and dtypes). No random ``@given`` draws:
every input is fixed, so every run checks the same cases, including the two
tiny run maxima whose fp16 scale goes subnormal."""
import numpy as np
import pytest

from repro.index import codec as ref
from repro_torch.index import codec as port

SEEDS = [0, 1, 2]


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _runs(rng, n_runs=200, max_cnt=300):
    """Random runs: per-run width, values below 2**width, and the
    (run_of, val_idx, word_start) layout ``pack_runs`` takes."""
    width = rng.choice(np.array(ref.WIDTHS, np.uint8), n_runs)
    cnt = rng.integers(0, max_cnt, n_runs)
    cnt[:3] = (0, 1, max_cnt)
    run_of = np.repeat(np.arange(n_runs), cnt)
    val_idx = np.arange(len(run_of)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    hi = (1 << width.astype(np.int64))[run_of]
    values = (rng.random(len(run_of)) * hi).astype(np.int64)
    words = ref.words_for(cnt, width)
    word_start = np.concatenate([[0], np.cumsum(words)[:-1]])
    return values, run_of, val_idx, width, word_start, cnt


def test_tables_equal():
    assert port.WIDTHS == ref.WIDTHS
    assert port.VALS_PER_WORD == ref.VALS_PER_WORD
    _assert_same(port._WIDTH_OF, ref._WIDTH_OF)


@pytest.mark.parametrize("seed", SEEDS)
def test_choose_width_and_words_for(seed):
    rng = np.random.default_rng(seed)
    max_val = rng.integers(0, 1 << 16, 2000) >> rng.integers(0, 17, 2000)
    max_val[:4] = (0, 1, 255, 0xFFFF)
    _assert_same(port.choose_width(max_val), ref.choose_width(max_val))
    count = rng.integers(0, 4096, 2000)
    width = rng.choice(ref.WIDTHS, 2000)
    _assert_same(port.words_for(count, width), ref.words_for(count, width))
    for codec in (port, ref):
        with pytest.raises(ValueError, match="16 bits"):
            codec.choose_width(np.array([0x10000]))


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_and_unpack_runs(seed):
    rng = np.random.default_rng(seed)
    values, run_of, val_idx, width, word_start, cnt = _runs(rng)
    packed = port.pack_runs(values, run_of, val_idx, width, word_start)
    _assert_same(packed, ref.pack_runs(values, run_of, val_idx, width,
                                       word_start))
    for r in range(0, len(cnt), 7):
        got = port.unpack_run(packed, int(word_start[r]), int(width[r]),
                              int(cnt[r]))
        _assert_same(got, ref.unpack_run(packed, int(word_start[r]),
                                         int(width[r]), int(cnt[r])))
        _assert_same(got, values[run_of == r])


@pytest.mark.parametrize("seed", SEEDS)
def test_delta_encode_decode(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 50, 2048):
        offs = np.sort(rng.choice(4096, n, replace=False))
        first, vals = port.delta_encode(offs)
        r_first, r_vals = ref.delta_encode(offs)
        assert first == r_first
        _assert_same(vals, r_vals)
        _assert_same(port.delta_decode(first, vals),
                     ref.delta_decode(r_first, r_vals))
    for codec in (port, ref):
        with pytest.raises(ValueError, match="increasing"):
            codec.delta_encode(np.array([3, 3]))


@pytest.mark.parametrize("seed", SEEDS)
def test_fp16_down(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.random(1000) * 10.0 ** rng.integers(-8, 6, 1000),
        np.float16(rng.random(100)).astype(np.float32),   # exact in fp16
        [0.0, 1e-8, 6e-8, 65504.0, 65519.0, 70000.0, 1e30]]).astype(
            np.float32)
    with np.errstate(over="ignore"):      # the cast overflows to +inf
        _assert_same(port.fp16_down(x), ref.fp16_down(x))


# The two run maxima where the reference's fp16 scale goes subnormal
# (ROADMAP Queue 3), then seeded runs of several magnitudes.
QUANT_CASES = [[0.0, 1e-05], [0.0, 3e-04]] + [
    (np.random.default_rng(s).random(64) * 10.0 ** (s - 3)).tolist()
    for s in range(6)]


@pytest.mark.parametrize("ws", QUANT_CASES,
                         ids=["tiny-1e-05", "tiny-3e-04"]
                         + [f"seed{s}" for s in range(6)])
def test_quantize_runs_single_run(ws):
    w = np.asarray(ws, np.float32)
    run_of = np.zeros(len(w), np.int64)
    got = port.quantize_runs(w, run_of, 1)
    want = ref.quantize_runs(w, run_of, 1)
    for a, b in zip(got, want):
        _assert_same(a, b)
    _assert_same(port.dequantize(*got), ref.dequantize(*want))


@pytest.mark.parametrize("seed", SEEDS)
def test_quantize_runs_many_runs(seed):
    """Runs of mixed lengths and scales, with empty runs in between."""
    rng = np.random.default_rng(seed)
    n_runs = 300
    cnt = rng.integers(0, 40, n_runs)
    run_of = np.repeat(np.arange(n_runs), cnt)
    w = (rng.random(len(run_of))
         * 10.0 ** rng.integers(-5, 3, n_runs)[run_of]).astype(np.float32)
    got, want = (c.quantize_runs(w, run_of, n_runs) for c in (port, ref))
    for a, b in zip(got, want):
        _assert_same(a, b)
    q, scale, zero = got
    _assert_same(port.dequantize(q, scale[run_of], zero[run_of]),
                 ref.dequantize(q, scale[run_of], zero[run_of]))
