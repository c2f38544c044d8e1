"""The traffic is the same for the same seed and keeps to its stated
ranges; another seed reorders the same make-up."""

import numpy as np

from perfbench import harness, scenes, weights


def serve_stream(base, seed, n):
    kind = harness.traffic_kind("serve_closed", base)
    cell = harness.workload("tiny.serve", base)
    run = kind.Cell(cell, seed, "cpu")
    rng = np.random.RandomState(weights.sub_seed(seed, "pool") % 2 ** 32)
    objects = scenes.stratified(rng, *cell["objects"], cell["pool_clips"])
    run.pool = scenes.make_clips(run.rcfg, objects, 5, frames=1,
                                 with_targets=False)
    stream = run._draws()
    return cell, run.pool, [next(stream) for _ in range(n)]


def test_same_seed_same_requests(tiny_base):
    _, _, a = serve_stream(tiny_base, 2 ** 31 + 17, 12)
    _, _, b = serve_stream(tiny_base, 2 ** 31 + 17, 12)
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[1] == y[1]
        assert np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])


def test_requests_keep_to_their_ranges(tiny_base):
    cell, pool, reqs = serve_stream(tiny_base, 4_000_000_001, 40)
    listed = sorted(cell["request_sizes"])
    sizes = [r[0] for r in reqs]
    # each listed size once in each cycle of the list
    for start in range(0, len(sizes) - len(listed) + 1, len(listed)):
        assert sorted(sizes[start:start + len(listed)]) == listed
    for size, offset, z, click in reqs:
        assert 0 <= offset <= cell["pool_clips"] - size
        assert z.shape[0] == size
        real = pool["num_real_nodes"][offset:offset + size]
        for row in range(size):
            k = int(click[row].sum())
            assert cell["clicks"][0] <= k or k == real[row]
            assert k <= min(cell["clicks"][1], real[row])
            assert not click[row, real[row]:].any()


def test_pool_objects_keep_to_their_range():
    rng = np.random.RandomState(3)
    counts = scenes.stratified(rng, 1, 16, 40)
    assert counts.min() >= 1 and counts.max() <= 16
    assert sorted(counts[:16]) == list(range(1, 17))
    other = scenes.stratified(np.random.RandomState(4), 1, 16, 32)
    assert sorted(other) == sorted(scenes.stratified(
        np.random.RandomState(3), 1, 16, 32))


def test_scenes_repeat_and_hold_their_objects():
    from conftest import tiny_config

    from perfbench.reference import config as rc
    cfg = rc._update_dataclass(rc.Config(), tiny_config())
    a = scenes.make_clips(cfg, [1, 4, 2], 99)
    b = scenes.make_clips(cfg, [1, 4, 2], 99)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert list(a["num_real_nodes"]) == [1, 4, 2]
    assert list(a["node_mask"].sum(1)) == [1, 4, 2]
    assert a["target_bw_of"].shape[1] == cfg.train_params.num_predicted_frames


def test_train_draws_repeat(tiny_base):
    kind = harness.traffic_kind("train_closed", tiny_base)
    cell = harness.workload("tiny.train", tiny_base)
    run = kind.Cell(cell, 123456789012, "cpu")
    run.host = {"num_real_nodes": np.array([1, 2, 3, 4, 1, 2])}
    for step in range(6):
        a, b = run._draws(step), run._draws(step)
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
        assert np.array_equal(a[2], b[2])
        off = a[0]
        assert a[2].sum() == run.batch
        real = run.host["num_real_nodes"][off:off + run.batch]
        assert all(a[2][r, :real[r]].sum() == 1 for r in range(run.batch))
    # the checked steps take rows that all differ
    assert [run._draws(s)[0] for s in range(3)] == [0, 2, 4]
