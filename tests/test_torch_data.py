"""The port's synthetic data pipeline (``repro_torch.data``) against the
reference's (``repro.data``), and twins of ``tests/test_substrate.py``'s
data cases.

The port draws from a ``torch.Generator`` seeded by ``batch_seed(seed,
step, shard)`` where the reference draws from ``jax.random`` (threefry), so
the numbers differ by design (ROADMAP queue 3): what is held to the
reference is the batch's keys, shapes and dtypes for every model of the
registry, the loss mask over the vlm's patches, and the token stream's law
(Zipf draws, clipped to the vocab, with the grammar rule at half the
positions, 0.5 +- 0.05 over 4,096 positions in both packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rc
from repro import data as ref_data
from repro_torch import configs as tc
from repro_torch.data import DataPipeline, synthetic_batch
from repro_torch.data.pipeline import batch_seed
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


def _cell(arch_id="internlm2-1.8b"):
    arch = tc.reduced(tc.get_arch(arch_id))
    return arch, tc.reduced_shape(tc.SHAPES_BY_NAME["train_4k"])


@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
def test_batch_keys_shapes_and_dtypes_match_reference(arch_id):
    arch_r = rc.reduced(rc.get_arch(arch_id))
    shape_r = rc.reduced_shape(rc.SHAPES_BY_NAME["train_4k"])
    arch_t, shape_t = _cell(arch_id)
    for shards, override in ((1, None), (2, 8)):
        want = ref_data.synthetic_batch(arch_r, shape_r, 0, 3,
                                        shard=1 % shards, num_shards=shards,
                                        batch_override=override)
        got = synthetic_batch(arch_t, shape_t, 0, 3, shard=1 % shards,
                              num_shards=shards, batch_override=override,
                              device="cpu")
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert got[k].dtype == _DTYPES[w.dtype.type], k
        np.testing.assert_array_equal(got["loss_mask"].numpy(),
                                      np.asarray(want["loss_mask"]))
        assert int(got["tokens"].min()) >= 0
        assert int(got["tokens"].max()) < arch_t.vocab_size


def _ref_follow(seed, step, shard, b, s):
    """The reference's grammar draws: ``bernoulli(k2, 0.5, (b, s + 1))``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), shard)
    _, k2, _ = jax.random.split(key, 3)
    return np.asarray(jax.random.bernoulli(k2, 0.5, (b, s + 1)))


def test_grammar_rule_holds_at_half_the_positions():
    """Redraw the port's stream in its stated order from ``batch_seed``:
    the batch is exactly the Zipf draws with the rule applied where the
    grammar's uniform is < 0.5, and the rule applies at 0.5 +- 0.05 of the
    positions, as the reference's bernoulli draws do."""
    arch, shape = _cell()
    shape = tc.ShapeConfig("t", 1024, 4, tc.StepKind.TRAIN)
    V = arch.vocab_size
    batch = synthetic_batch(arch, shape, 7, 2, shard=1, num_shards=1,
                            device="cpu")
    gen = torch.Generator().manual_seed(batch_seed(7, 2, 1))
    u = torch.rand((4, 1025), generator=gen)
    base = torch.clamp(torch.exp(u * np.log(V)).to(torch.int32) - 1, 0,
                       V - 1)
    follow = torch.rand((4, 1025), generator=gen) < 0.5
    stream = torch.where(follow, (torch.roll(base, 1, 1) * 7 + 1) % V, base)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  stream[:, :-1].numpy())
    assert abs(float(follow.float().mean()) - 0.5) <= 0.05
    ref_share = _ref_follow(7, 2, 1, 4, 1024).mean()
    assert abs(ref_share - 0.5) <= 0.05
    # Zipf: the mass sits on small ids (median id far below V / 2)
    assert float(base.float().median()) < V / 8


def test_batch_seed_separates_seed_step_and_shard():
    seeds = {batch_seed(s, t, h) for s in range(3) for t in range(3)
             for h in range(3)}
    assert len(seeds) == 27 and all(0 <= x < 2**63 for x in seeds)


def test_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch, shape = _cell()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_batch(arch, shape, 0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataPipeline(arch, shape)


# ---------------------------------------------------------------------------
# twins of tests/test_substrate.py's data cases
# ---------------------------------------------------------------------------

def test_data_deterministic_and_sharded():
    arch, shape = _cell()
    b1 = synthetic_batch(arch, shape, seed=0, step=5, shard=0, num_shards=2,
                         device="cpu")
    b2 = synthetic_batch(arch, shape, seed=0, step=5, shard=0, num_shards=2,
                         device="cpu")
    np.testing.assert_array_equal(b1["tokens"].numpy(), b2["tokens"].numpy())
    b3 = synthetic_batch(arch, shape, seed=0, step=5, shard=1, num_shards=2,
                         device="cpu")
    assert not np.array_equal(b1["tokens"].numpy(),
                              b3["tokens"].numpy()), "shards must differ"
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:].numpy(),
                                  b1["labels"][:, :-1].numpy())


def test_data_cursor_restart():
    arch, shape = _cell()
    p1 = DataPipeline(arch, shape, device="cpu")
    for _ in range(3):
        p1.next()
    # restart from the replicated cursor: must resume at step 3
    p2 = DataPipeline(arch, shape, device="cpu")
    p2.restore(p1.cursor)
    assert p2.step == 3
    b3 = p2.next()
    p1b = DataPipeline(arch, shape, device="cpu")
    for _ in range(3):
        p1b.next()
    expected = p1b.next()
    np.testing.assert_array_equal(b3["tokens"].numpy(),
                                  expected["tokens"].numpy())
    # max-merge: an older cursor never rewinds
    p2.restore(DataPipeline(arch, shape, device="cpu").cursor)
    assert p2.step == 4
