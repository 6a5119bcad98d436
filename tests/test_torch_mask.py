"""The port's block-importance mask against the JAX package's: identical
(block_idx, block_cnt) on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.sparse import mask as JM  # noqa: E402
from repro_torch.sparse import mask as TM  # noqa: E402


def _both(x, qb, kb, mass, causal=True):
    jsc = JM.block_scores(jnp.asarray(x), jnp.asarray(x), q_block=qb,
                          kv_block=kb, causal=causal)
    jidx, jcnt = JM.select_blocks(jsc, mass=mass, q_block=qb, kv_block=kb)
    t = torch.from_numpy(x)
    tsc = TM.block_scores(t, t, q_block=qb, kv_block=kb, causal=causal)
    tidx, tcnt = TM.select_blocks(tsc, mass=mass, q_block=qb, kv_block=kb)
    return (np.asarray(jsc), np.asarray(jidx), np.asarray(jcnt),
            tsc.numpy(), tidx.numpy(), tcnt.numpy())


@pytest.mark.parametrize("bh,s,d,qb,kb,mass,causal", [
    (1, 96, 64, 16, 16, 0.98, True),      # the serving engine's surrogate
    (2, 512, 64, 128, 128, 0.9, True),
    (3, 256, 32, 32, 64, 0.95, True),
    (2, 256, 64, 64, 64, 0.85, False),
])
def test_select_blocks_matches_reference(bh, s, d, qb, kb, mass, causal):
    x = np.random.default_rng(s + bh).normal(size=(bh, s, d)) \
        .astype(np.float32)
    jsc, jidx, jcnt, tsc, tidx, tcnt = _both(x, qb, kb, mass, causal)
    # pooled scores: fp32 sums in two reduction orders, ~1 ulp apart
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-6)
    assert tidx.dtype == np.int32 and tcnt.dtype == np.int32
    assert np.array_equal(tidx, jidx)
    assert np.array_equal(tcnt, jcnt)


def test_tied_scores_keep_reference_order():
    """Identical blocks give exactly tied scores: the stable sort must
    keep index order, as jnp.argsort does."""
    rng = np.random.default_rng(1)
    block = rng.normal(size=(1, 16, 32)).astype(np.float32)
    x = np.tile(block, (1, 8, 1))                 # 8 identical 16-token blocks
    jsc, jidx, jcnt, tsc, tidx, tcnt = _both(x, 16, 16, 0.98)
    # the two packages may land one ulp apart, but each ties exactly
    np.testing.assert_allclose(tsc, jsc, rtol=1e-6)
    assert np.array_equal(tidx, jidx)
    assert np.array_equal(tcnt, jcnt)
    # ties really occur: every valid score of a row is the same value
    row = tsc[0, -1]
    assert np.unique(row[np.isfinite(row)]).size == 1


def test_trim_and_fraction_match_reference():
    x = np.random.default_rng(5).normal(size=(2, 256, 32)).astype(np.float32)
    _, jidx, jcnt, _, tidx, tcnt = _both(x, 32, 32, 0.9)
    ji, jc = JM.trim_nnz(jidx, jcnt, multiple=2)
    ti, tc = TM.trim_nnz(torch.from_numpy(tidx), torch.from_numpy(tcnt),
                         multiple=2)
    assert np.array_equal(ti, ji) and np.array_equal(tc, jc)
    assert TM.active_block_fraction(torch.from_numpy(tcnt), 8) == \
        JM.active_block_fraction(jnp.asarray(jcnt), 8)
