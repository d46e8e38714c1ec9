"""Scoped dispatch-flag overrides (randblas_tpu.flags)."""

import numpy as np
import pytest

import randblas_tpu as rb
from randblas_tpu import flags, get_flag, set_flag


def test_flags_scope_and_restore():
    assert get_flag("use_fused") == "auto"
    with flags(use_fused=False, use_native_x64=False):
        assert get_flag("use_fused") is False
        assert get_flag("use_native_x64") is False
    assert get_flag("use_fused") == "auto"
    assert get_flag("use_native_x64") == "auto"


def test_flags_restore_on_exception():
    with pytest.raises(RuntimeError):
        with flags(use_hiprec_f64=True):
            assert get_flag("use_hiprec_f64") is True
            raise RuntimeError("boom")
    assert get_flag("use_hiprec_f64") == "auto"


def test_flags_unknown_name():
    with pytest.raises(ValueError, match="unknown randblas_tpu flag"):
        with flags(not_a_flag=1):
            pass


def test_flags_affect_dispatch():
    """use_fused=False forces the staged path (results still agree)."""
    import jax.numpy as jnp
    S = rb.DenseSkOp(rb.DenseDist(16, 64), rb.RNGState.from_key(1))
    A = jnp.asarray(np.random.default_rng(0).normal(
        size=(64, 8)).astype(np.float32))
    with flags(use_fused=False):
        staged = np.asarray(rb.sketch(S, A))
    want = np.asarray(S.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(staged, want, rtol=1e-5, atol=1e-5)


def test_set_flag_direct():
    set_flag("use_fused", False)
    try:
        assert get_flag("use_fused") is False
        from randblas_tpu import skge
        assert skge.use_fused is False   # same storage, not a copy
    finally:
        set_flag("use_fused", "auto")
