"""The port's tensor-parallel steps of the ssm family (xlstm) on gloo worlds
of CPU ranks, against the reference's jitted steps on the same meshes of
forced host devices: the harness, the inputs and the bounds of
``tests/test_torch_tensor_parallel_hybrid.py`` for the reduced xlstm (8
layers: 7 mLSTM layers of 2 heads, d_inner 256, then an sLSTM with a
feed-forward of 170; d 128, a tied embedding).  It serves on (data 2,
model 2) only (170 does not split by 4): one mLSTM head a rank, the
sLSTM recurrence whole on every rank.  The mLSTM gates' weights ``w_if``
are cut to the rank's heads in both halves, and the gate biases and the
groupnorm scales are perturbed from their constant init, so a head cut
in the wrong place shows.
"""
import jax
import pytest

import torch_tp_recurrent_ranks as ranks
from test_torch_tensor_parallel_hybrid import (check_decode, check_pods,
                                               check_prefill, check_train,
                                               reference_out, run_worlds,
                                               start_reference,
                                               stop_reference)
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

FAMILY = "ssm"
MESHES = ranks.SERVE_MESHES[FAMILY]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_ssm")


@pytest.fixture(scope="module")
def reference_proc(workdir):
    proc = start_reference(workdir, FAMILY)
    yield proc
    stop_reference(proc)


@pytest.fixture(scope="module")
def reference(reference_proc, workdir):
    return reference_out(reference_proc, workdir)


@pytest.fixture(scope="module")
def worlds(reference_proc, workdir):
    return run_worlds(workdir, FAMILY)


@pytest.fixture(scope="module")
def four(worlds):
    return worlds["four"]


@pytest.fixture(scope="module")
def pods(worlds):
    return worlds["pods"]


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("ms", MESHES, ids=MESH_IDS)
def test_prefill_matches_reference(four, reference, ms, impl):
    """The last logits (the tied embedding's vocabulary shards) within
    1e-4 of the reference's largest; every cache leaf gathered (the mLSTM
    conv windows by d_inner, C, n and m by heads, the sLSTM state whole)
    within 1e-5 of the reference's."""
    check_prefill(four["serve"][ms], reference, ms, impl)


@pytest.mark.parametrize("ms", MESHES, ids=MESH_IDS)
def test_decode_matches_reference(four, reference, ms):
    """3 greedy steps from the prefill's cache: tokens equal, the gathered
    caches within 1e-5."""
    check_decode(four["serve"][ms], reference, ms)


@pytest.mark.parametrize("mode", sorted(ranks.TRAIN_MODES))
def test_train_matches_reference(four, reference, mode):
    """2 steps on (data 2, model 2) (the sLSTM's eager loop under
    autograd): loss, ce and grad_norm at each, the first step's gradients
    (every leaf ``tp_view`` cuts among them), the state after."""
    check_train(four["train"], reference, FAMILY, mode)


def test_replicated_round_matches_reference(pods, reference):
    """(pod 2, data 2, model 2): each pod's REPLICATED steps, then one
    anti-entropy round."""
    check_pods(pods, reference)


def test_init_cache_holds_the_rank_part(four):
    """``init_cache(mesh=)`` gives the shapes of the rank's prefill
    cache."""
    for ms in MESHES:
        assert four["serve"][ms]["init_cache/same_shapes"], ms
