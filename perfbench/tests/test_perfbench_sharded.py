"""CPU tests of the sharded grad cell (drivers/sharded_grad_steps.py) at a
tiny size on four gloo ranks: a sound run, traced or not, comes out correct;
the control and each planted fault, the two sharding faults included, do
not; a program without the sharded entry points fails before any rank
starts; the collectives' byte count and readers; and the reference's
gradient taken in blocks of lanes equals the one taken whole."""
from __future__ import annotations

import json
import multiprocessing
import time

import pytest
import torch

from perfbench.core import collectives, compare, port_shard, ranks, runner
from perfbench.core.cell import load_cell
from perfbench.core.record import Record
from perfbench.core.trace import Trace
from perfbench.tools import sharded_readings

CELL = "plume-dp4.grad-1mp16"
SMALL = {"config": {"max_depth": 3},
         "traffic": {"width": 16, "height": 16, "spp": 4, "trace_steps": 2,
                     "check": {"block_lanes": 4096, "grad_block_lanes": 100}}}
SEED = 2 ** 31 + 977


def _small_cell():
    return load_cell(CELL, overrides=json.loads(json.dumps(SMALL)))


def _measure(trace=False):
    return runner.measure(CELL, SEED, 0.5, trace, time.perf_counter(), device="cpu",
                          overrides=json.loads(json.dumps(SMALL)))[0]


def test_a_sound_run_is_correct():
    res = _measure()
    assert res["correct"], res["checks"]
    assert {"grad_step_ms", "setup_s"} <= set(res["metrics"])
    assert res["device"]["count"] == 4


def test_a_traced_run_is_correct_and_counts_its_collectives(capsys):
    res = _measure(trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    line = [x for x in capsys.readouterr().err.splitlines() if x.startswith('{"ranks"')][-1]
    report = json.loads(line)
    want = collectives.step_bytes(_small_cell())
    assert report["collective_bytes_per_step"] == want == 16 * 16 * 3 * 8 + 4 * (32769 + 6)
    for r in report["ranks"]:   # the program's counters: two collectives and 256 lanes a step
        assert r["counted_per_unit"] == {"shard.allreduce.calls": 2.0,
                                         "shard.allreduce.bytes": float(want),
                                         "shard.lanes": 256.0}


@pytest.mark.parametrize("fault", sorted(sharded_readings.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    cell = _small_cell()
    rec = cell.driver().run(cell, SEED, 0.5, False, "cpu", time.perf_counter(),
                            prepare=sharded_readings.FAULTS[fault])
    ok, checks = compare.judge(rec.numbers, cell.limits)
    assert not ok, checks


def _control_rank(rank, cell, port_no):
    from perfbench.core import port
    from perfbench.drivers import grad_steps
    from perfbench.drivers import sharded_grad_steps as D

    dev = port_shard.start(rank, cell.chips, port_no, "cpu", "gloo", 120)
    try:
        data = cell.scene()
        p0 = grad_steps.initial_params(cell, port.media(data, dev), SEED, dev)
        return compare.train_numbers(D.reference_steps(cell, data, SEED, dev, p0, rank,
                                                       torch.bfloat16),
                                     D.reference_steps(cell, data, SEED, dev, p0, rank))
    finally:
        port_shard.stop()


def test_the_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails the limits."""
    cell = _small_cell()
    nums = ranks.run(4, __name__, "_control_rank", (cell, port_shard.free_port()), timeout=300,
                     watch=False)[0]
    ok, checks = compare.judge(nums, cell.limits)
    assert not ok, checks


def test_a_program_without_the_entry_points_fails_before_any_rank(monkeypatch):
    from cudatracerlib_tpu_torch.parallel import shard

    monkeypatch.delattr(shard, "make_sharded_render_vol")
    cell = _small_cell()
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="make_sharded_render_vol"):
        cell.driver().run(cell, SEED, 0.5, False, "cpu", t)
    assert time.perf_counter() - t < 5 and not multiprocessing.active_children()


def test_the_cpu_refuses_the_full_size():
    cell = load_cell(CELL)
    with pytest.raises(ValueError, match="test sizes"):
        cell.driver().run(cell, SEED, 0.5, False, "cpu", time.perf_counter())


def test_the_collective_byte_count_and_readers():
    """The full cell's bytes a step (the film's 1024 x 1024 x 3 float64
    values, the grid's 32,769 rows and two triples in float32), and the
    readers on a synthetic traced record of four ranks and two steps."""
    cell = load_cell(CELL)
    assert collectives.step_bytes(cell) == 1024 * 1024 * 3 * 8 + 4 * (32769 + 3 + 3) == 25296924
    kernels = [("ncclDevKernel_AllReduce_Sum_f64_RING_LL(x)", 0.0, 100.0),
               ("elementwise", 0.0, 5.0), ("nccl:all_reduce", 0.0, 100.0),
               ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 200.0, 210.0)]
    assert collectives.collective_seconds(kernels) == pytest.approx([1e-4, 1e-5])
    per_rank = [[1e-4, 1e-5, 2e-4, 2e-5], [3e-4, 1e-5, 1e-4, 4e-5],
                [1e-4, 2e-5, 1e-4, 1e-5], [5e-4, 1e-5, 1e-4, 1e-5]]
    rec = collectives.ShardedRecord(unit="step", setup_s=1.0, unit_walls=[1.0, 1.0],
                                    trace=Trace(kernels=[], wall_s=2.0, busy_s=1.0),
                                    collectives=per_rank, collective_bytes=10 ** 9,
                                    link_bytes_per_s=4e12)
    read = lambda name: cell.reader(name).read(rec)  # noqa: E731
    least = (1e-4 + 1e-5 + 1e-4 + 1e-5) / 2 * 1e3
    assert read("allreduce_ms.grad4") == pytest.approx(least)
    assert read("rank_wait_ms.grad4") == pytest.approx((4e-4 + 1e-5 + 1e-4 + 3e-5) / 2 * 1e3)
    assert read("allreduce_bw_share.grad4") == pytest.approx(1e9 / (least * 1e-3) / 4e12)
    rec.collectives = [per_rank[0], per_rank[1][:3], per_rank[2], per_rank[3]]
    assert read("allreduce_ms.grad4") is None       # a rank's count differs
    rec.collectives, rec.trace = per_rank, None
    assert read("rank_wait_ms.grad4") is None       # untraced
    assert cell.reader("allreduce_ms.grad4").read(
        Record(unit="step", setup_s=1.0, unit_walls=[1.0], trace=rec.trace)) is None


def test_the_blocked_reference_gradient_equals_the_whole():
    """At a small size, the reference's gradient taken in blocks of lanes
    (each replaying the whole batch's tracking skips, the grid gathered by
    index_select) against autograd of the whole batch's radiance through
    volume.RefMedium itself."""
    from perfbench.reference import volume, volume_sharded
    from perfbench.reference.common import RefScene

    cell = _small_cell()
    data = cell.scene()
    rs = RefScene(data, "cpu")
    rec = data["media"][0]
    params = {"grid_data": torch.cat([torch.ones(1), torch.as_tensor(rec["density"]).reshape(-1)]),
              "sigma_a": torch.tensor([rec["sigma_a"]]), "sigma_s": torch.tensor([rec["sigma_s"]])}
    params = {k: v.float().requires_grad_() for k, v in params.items()}
    med = volume_sharded.medium(rec, "cpu", params=params)
    plain = volume.RefMedium(rec, "cpu", params=params)
    pix, smp = volume_sharded.rank_lanes(4, 1, 2, 16, 16, 4, "cpu")
    L, skips = volume_sharded.radiance_whole(rs, med, pix, smp, 16, 16, 5, 4096)
    assert max(skips) > 0
    cot = torch.rand(L.shape, generator=torch.Generator().manual_seed(0))
    o, d, st = rs.camera_rays(pix, smp, 16, 16, 5)
    whole = torch.nan_to_num(volume.radiance(rs, plain, o, d, st, 4096))
    assert torch.equal(whole.detach(), L)
    want = torch.autograd.grad((whole * cot).sum(), list(params.values()))
    for block in (7, 100):
        got = volume_sharded.lane_gradient(rs, med, params, pix, smp, 16, 16, 5, 4096, skips, cot,
                                           block)
        for (k, g), w in zip(got.items(), want):
            assert float(w.abs().max()) > 0, k
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))
