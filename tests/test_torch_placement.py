"""The port's placement constructors ask for cards, not TPU chips.

``pipeline_stage_placement_group``, ``PodracerPlacement`` and
``SlicePlacementGroup`` turn chip counts into ``GPU`` bundles, which a
port node has, and never into ``TPU`` bundles, which no port node has: on
a cluster declaring two GPUs each group places within 10 s.  A non-empty
``accelerator_version`` raises, since a GPU node carries its model as a
label, not as a resource.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.core_worker import global_worker
from ray_tpu_torch.core.placement import (
    PodracerPlacement,
    SlicePlacementGroup,
    pipeline_stage_placement_group,
    remove_placement_group,
)


@pytest.fixture(scope="module")
def cluster():
    ctx = ray_tpu_torch.init(num_cpus=4, resources={"GPU": 2})
    yield ctx
    ray_tpu_torch.shutdown()


def _pipeline():
    pg = pipeline_stage_placement_group(2, chips_per_stage=1)
    return pg, pg.bundles, pg.ready, lambda: remove_placement_group(pg)


def _podracer():
    pod = PodracerPlacement(1, 1, chips_per_actor=1, chips_per_learner=1)
    return pod.pg, pod.pg.bundles, pod.ready, pod.remove


def _slice():
    spg = SlicePlacementGroup(1, chips_per_host=2)
    return spg.pg, spg.pg.bundles, spg.ready, spg.remove


CASES = {
    "pipeline_stages": (_pipeline, [{"CPU": 1.0, "GPU": 1.0}] * 2, "SPREAD"),
    "podracer": (_podracer, [{"CPU": 1.0, "GPU": 1.0}] * 2, "SPREAD"),
    "slice": (_slice, [{"GPU": 2.0}], "PACK"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chip_bundles_ask_for_gpus_and_place(cluster, name):
    make, want_bundles, want_strategy = CASES[name]
    pg, bundles, ready, remove = make()
    try:
        assert bundles == want_bundles
        assert all("TPU" not in b for b in bundles)
        assert ready(timeout=10)
        worker = global_worker()
        info = worker._run_sync(
            worker.cp.call("get_placement_group", {"pg_id": pg.id}))
        assert info["strategy"] == want_strategy, info
    finally:
        remove()


def test_multi_host_slice_keeps_strict_spread():
    # One bundle per host on distinct hosts is the slice's meaning; this
    # only builds the bundles, it does not need two hosts to place.
    from ray_tpu_torch.core import placement

    made = {}

    def fake_placement_group(bundles, strategy, name, priority):
        made.update(bundles=bundles, strategy=strategy)
        return "pg"

    orig = placement.placement_group
    placement.placement_group = fake_placement_group
    try:
        SlicePlacementGroup(2, chips_per_host=4)
    finally:
        placement.placement_group = orig
    assert made == {"bundles": [{"GPU": 4.0}] * 2,
                    "strategy": "STRICT_SPREAD"}


@pytest.mark.parametrize("make", [
    lambda: pipeline_stage_placement_group(2, chips_per_stage=1,
                                           accelerator_version="H100"),
    lambda: PodracerPlacement(1, 1, chips_per_actor=1,
                              accelerator_version="H100"),
    lambda: SlicePlacementGroup(1, chips_per_host=1,
                                accelerator_version="H100"),
], ids=["pipeline_stages", "podracer", "slice"])
def test_accelerator_version_raises(make):
    with pytest.raises(ValueError, match="accelerator_type"):
        make()
