"""Per-episode exogenous-row prefetch (ops/gather.py) against a numpy loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sustaingym_tpu.ops.gather import episode_slice_gather


@pytest.mark.parametrize("rows,cols,batch,length", [
    (105408, 4, 64, 288),    # BuildingEnv exog shape
    (105408, 4, 64, 7),      # partial segment
    (1000, 7, 33, 96),       # cogen-like (odd cols)
    (513, 1, 5, 17),         # degenerate small
    (4096, 4, 768, 32),      # mid-size batch
    (4096, 4, 1025, 32),     # odd batch
    (2890, 201, 33, 96),     # EV step-table-like wide rows
    (500, 128, 7, 12),       # exactly 128 columns
    (2890, 201, 100, 96),    # wide rows, larger batch
])
def test_slice_gather_matches_numpy(rows, cols, batch, length):
    table = jax.random.uniform(jax.random.PRNGKey(0), (rows, cols),
                               jnp.float32)
    starts = jax.random.randint(
        jax.random.PRNGKey(1), (batch,), 0, rows - length)
    out = np.asarray(episode_slice_gather(table, starts, length))
    t, s = np.asarray(table), np.asarray(starts)
    ref = np.stack([t[e:e + length] for e in s])
    assert out.shape == (batch, length, cols)
    np.testing.assert_array_equal(out, ref)
