"""Fixed-histogram change-detector tests for the float transforms.

Port of the reference's run_ut_uniform tier
(/root/reference/test/test_basic_rng/test_r123.cc:560-668): stream
Threefry4x32 blocks for counters 1..1000 with a zero key, push every word
through u01 / uneg11 / u01fixedpt, and histogram into 26 bins over [-1, 1]
(bin = int((u + 1) * 13), computed in float like the reference). The
histograms are pinned to fixed values — a change detector distinct from
the KS statistical tier: any drift in the uint32 stream OR the float maps
flips a bin.

The pinned x32 values agree with the reference's refmap (test_r123.cc:
607-625) because the uint32 streams are bit-identical (KAT-verified) and
the u01-family maps are exact float arithmetic — matching them here is
itself a cross-implementation check. The x64 rows run through the native
host engine's 64-bit CBRNGs (JAX runs without x64 mode).
"""

import numpy as np
import pytest

import randblas_tpu.rng.transforms as tr
from randblas_tpu.rng import threefry4x32

NBINS = 26
N_ITERS = 1000

# Pinned histograms (26 space-separated bin counts). These equal the
# reference's refmap entries for the same (transform, generator) pairs.
HIST_U01_TF4X32 = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 301, 330, 326,
                   320, 295, 291, 298, 287, 305, 307, 310, 316, 314]
HIST_UNEG11_TF4X32 = [156, 139, 148, 146, 159, 148, 159, 168, 142, 160,
                      156, 161, 153, 143, 158, 150, 180, 174, 152, 163,
                      157, 129, 166, 151, 140, 142]
HIST_U01FIXEDPT_TF4X32 = HIST_U01_TF4X32  # same bins: both ~u * 2^-32
HIST_U01_TF4X64 = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 308, 295, 322,
                   300, 316, 291, 311, 289, 346, 297, 310, 340, 275]
HIST_UNEG11_TF4X64 = [159, 141, 148, 184, 162, 142, 155, 137, 173, 187,
                      153, 140, 135, 164, 144, 146, 149, 151, 171, 152,
                      148, 137, 179, 146, 145, 152]
HIST_U01FIXEDPT_TF4X64 = HIST_U01_TF4X64


def _histogram(values_f32):
    """bin = int((u + 1) * 13) evaluated in float32, like the reference."""
    u = np.asarray(values_f32, np.float32)
    assert (u >= -1.0).all() and (u <= 1.0).all()
    idx = ((u + np.float32(1.0)) * np.float32(NBINS // 2)).astype(np.int64)
    return np.bincount(idx, minlength=NBINS).tolist()


def _tf4x32_words():
    """Raw words for counters {1..N_ITERS} (word 0), zero key, 20 rounds."""
    ctrs = np.zeros((N_ITERS, 4), np.uint32)
    ctrs[:, 0] = np.arange(1, N_ITERS + 1, dtype=np.uint32)
    out = threefry4x32(ctrs, np.zeros(4, np.uint32), 20)
    return np.asarray(out).reshape(-1)


@pytest.fixture(scope="module")
def tf32_words():
    return _tf4x32_words()


def test_u01_histogram(tf32_words):
    assert _histogram(tr.u01(tf32_words)) == HIST_U01_TF4X32


def test_uneg11_histogram(tf32_words):
    assert _histogram(tr.uneg11(tf32_words)) == HIST_UNEG11_TF4X32


def test_u01fixedpt_histogram(tf32_words):
    assert _histogram(tr.u01fixedpt(tf32_words)) == HIST_U01FIXEDPT_TF4X32


def test_u01fixedpt_values():
    """Outputs are exactly the odd multiples of 2^-24 in (0, 1)."""
    bits = np.array([0, 0xFF, 0x100, 0xFFFFFFFF, 0x80000000], np.uint32)
    vals = np.asarray(tr.u01fixedpt(bits))
    expect = ((bits >> 8) | 1).astype(np.float32) * np.float32(2.0 ** -24)
    np.testing.assert_array_equal(vals, expect)
    assert vals.min() >= 2.0 ** -24 and vals.max() <= 1 - 2.0 ** -24
    # all outputs odd multiples of 2^-24
    ints = vals / np.float32(2.0 ** -24)
    assert (ints == np.round(ints)).all() and (ints.astype(np.int64)
                                               % 2 == 1).all()


# --------------------------- 64-bit rows -----------------------------------

def _tf4x64_words():
    from randblas_tpu import native
    if not native.available():
        pytest.skip("native engine unavailable")
    ctrs = np.zeros((N_ITERS, 4), np.uint64)
    ctrs[:, 0] = np.arange(1, N_ITERS + 1, dtype=np.uint64)
    out = native.cbrng64("threefry4x64", ctrs, np.zeros(4, np.uint64), 20)
    return out.reshape(-1)


@pytest.fixture(scope="module")
def tf64_words():
    return _tf4x64_words()


def _u01_64(u):
    return (u.astype(np.float32) * np.float32(2.0 ** -64)
            + np.float32(2.0 ** -65))


def _uneg11_64(u):
    return (u.view(np.int64).astype(np.float32) * np.float32(2.0 ** -63)
            + np.float32(2.0 ** -64))


def _u01fixedpt_64(u):
    # B = min(24 mantissa bits, 64) = 24; excess = 40
    return (((u >> np.uint64(40)) | np.uint64(1)).astype(np.float32)
            * np.float32(2.0 ** -24))


def test_u01_histogram_x64(tf64_words):
    assert _histogram(_u01_64(tf64_words)) == HIST_U01_TF4X64


def test_uneg11_histogram_x64(tf64_words):
    assert _histogram(_uneg11_64(tf64_words)) == HIST_UNEG11_TF4X64


def test_u01fixedpt_histogram_x64(tf64_words):
    assert _histogram(_u01fixedpt_64(tf64_words)) == HIST_U01FIXEDPT_TF4X64
