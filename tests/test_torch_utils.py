"""The port's utils/ (settings, timing, checkpoints), sampling/samplers and
`rng.stratified_offsets`, and the render CLI, against the JAX package on the
CPU.

Checks, stated once:
  * settings: JAX test_io's TestSettings cases on both packages' modules;
  * checkpoints: the JAX package's file format (`leaf_<i>`, `__paths__`, the
    npz written to a temporary name and renamed): a Film and a nested tree
    written by either package load in the other, leaves equal, paths equal;
    ProgressiveCheckpoint saves every K passes and resumes after the last;
  * SequenceTable: tables equal to JAX's for each kind, draws equal bit for
    bit; stratified_offsets equal;
  * the CLI (`python -m cudatracerlib_tpu_torch.cli`, here its `main` with
    `--device cpu`): each tracer, one pass at 16x16 on Cornell, exits 0 and
    writes a PNG; an XML and an OBJ scene render; two passes checkpointed
    and resumed to three equal three straight passes bit for bit.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.image.film import Film as JFilm
from cudatracerlib_tpu.sampling import rng as jrng
from cudatracerlib_tpu.sampling import samplers as jsamplers
from cudatracerlib_tpu.utils import checkpoint as jck
from cudatracerlib_tpu.utils import settings as jsettings
from cudatracerlib_tpu_torch import cli
from cudatracerlib_tpu_torch.image.film import Film as TFilm
from cudatracerlib_tpu_torch.sampling import rng as trng
from cudatracerlib_tpu_torch.sampling import samplers as tsamplers
from cudatracerlib_tpu_torch.utils import checkpoint as tck
from cudatracerlib_tpu_torch.utils import settings as tsettings
from cudatracerlib_tpu_torch.utils import timing as ttiming

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import io_cases  # noqa: E402  (tools/io_cases.py, numpy only)


@pytest.mark.parametrize("mod", [tsettings, jsettings], ids=["port", "jax"])
def test_settings(mod):
    p = mod.Parameter("depth", 5, interval=(1, 64))
    with pytest.raises(ValueError):
        p.set(0)
    p.set(10)
    assert p.get() == 10
    e = mod.Parameter("mode", "fast", enum={"fast": 0, "quality": 1})
    assert e.get() == 0 and e.as_string() == "fast"
    with pytest.raises(ValueError):
        e.set("bogus")
    root = mod.ParameterCollection("tracer")
    root.add(mod.Parameter("depth", 5, interval=(1, 64)))
    child = root.add_child(mod.ParameterCollection("sampler"))
    child.add(mod.Parameter("spp", 4, interval=(1, 4096)))
    root.apply_overrides(["depth=8", "sampler.spp=64"])
    assert root["depth"] == 8 and root["sampler.spp"] == 64
    assert root.to_dict()["sampler"]["spp"] == 64


def _film(pkg):
    if pkg == "port":
        f = TFilm.create(8, 8, device="cpu")
        return f._replace(rgb=f.rgb + 1.5, splat=f.splat + torch.arange(3.0),
                          n_passes=torch.tensor(3.0))
    f = JFilm.create(8, 8)
    return f._replace(rgb=f.rgb + 1.5, splat=f.splat + jnp.arange(3.0), n_passes=jnp.float32(3))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_roundtrip_across_packages(tmp_path, writer):
    """A Film and a nested tree (dict, NamedTuple, list, None, scalars)
    written by one package load in both; the files list the same paths."""
    tree = {"film": _film(writer), "pass_idx": np.int32(7),
            "extra": [np.arange(4, dtype=np.float32), None, (np.float32(2.5),)]}
    path = str(tmp_path / "ck.npz")
    (tck if writer == "port" else jck).save_pytree(path, tree)
    assert not os.path.exists(path + ".tmp.npz")
    got = tck.load_pytree(path, {"film": TFilm.create(8, 8, device="cpu"), "pass_idx": np.int32(0),
                                 "extra": [np.zeros(4, np.float32), None, (np.float32(0),)]})
    ref = jck.load_pytree(path, {"film": JFilm.create(8, 8), "pass_idx": jnp.int32(0),
                                 "extra": [jnp.zeros(4), None, (jnp.float32(0),)]})
    assert isinstance(got["film"], TFilm) and isinstance(got["film"].rgb, torch.Tensor)
    np.testing.assert_array_equal(got["film"].rgb.numpy(), 1.5)
    for a, b in zip(got["film"], ref["film"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got["pass_idx"]) == int(ref["pass_idx"]) == 7
    np.testing.assert_array_equal(got["extra"][0].numpy(), np.arange(4))
    assert got["extra"][1] is None and float(got["extra"][2][0]) == 2.5
    other = str(tmp_path / "other.npz")
    (jck if writer == "port" else tck).save_pytree(other, tree if writer == "jax" else {
        "film": _film("jax"), "pass_idx": np.int32(7),
        "extra": [np.arange(4, dtype=np.float32), None, (np.float32(2.5),)]})
    a, b = np.load(path, allow_pickle=True), np.load(other, allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    assert list(a["__paths__"]) == list(b["__paths__"])
    for k in a.files:
        if k != "__paths__":
            np.testing.assert_array_equal(a[k], b[k])


def test_progressive_checkpoint(tmp_path):
    ck = tck.ProgressiveCheckpoint(str(tmp_path / "p.npz"), every=2)
    film = TFilm.create(4, 4, device="cpu")
    assert ck.load(film) == (None, 0)
    ck.maybe_save(film._replace(rgb=film.rgb + 1), 0)       # pass 1: not a multiple of 2
    assert not os.path.exists(ck.path)
    ck.maybe_save(film._replace(rgb=film.rgb + 2), 1)
    loaded, start = ck.load(film)
    assert start == 2 and float(loaded.rgb.mean()) == 2.0
    jloaded, jstart = jck.ProgressiveCheckpoint(ck.path, 2).load(JFilm.create(4, 4))
    assert jstart == 2 and float(jloaded.rgb.mean()) == 2.0


def test_timing():
    timer = ttiming.PerformanceTimer()
    for _ in range(3):
        with timer.measure("block", sync=True, sync_value={"x": torch.ones(4)}):
            torch.ones(1000).sum()
    b = timer.blocks["block"]
    assert b.n == 3 and b.mean > 0 and b.stddev >= 0 and "block: n=3" in timer.report()
    ttiming.block_until_ready((torch.zeros(2), [torch.ones(1)]))   # CPU tensors: no wait


@pytest.mark.parametrize("kind", [tsamplers.INDEPENDENT, tsamplers.STRATIFIED, tsamplers.HALTON,
                                  tsamplers.SOBOL])
def test_sequence_table_draws_equal_jax(kind):
    t = tsamplers.SequenceTable.build(kind, 64, 8, device="cpu")
    j = jsamplers.SequenceTable.build(kind, 64, 8)
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    rng = np.random.default_rng(kind)
    pix = rng.integers(0, 1 << 20, 4096).astype(np.uint32)
    idx = rng.integers(0, 1000, 4096)
    dim = rng.integers(0, 20, 4096)
    got = t.sample(torch.from_numpy(pix.astype(np.int64)), torch.from_numpy(idx),
                   torch.from_numpy(dim))
    ref = j.sample(jnp.asarray(pix), jnp.asarray(idx), jnp.asarray(dim))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
    np.testing.assert_array_equal(tsamplers.radical_inverse(3, np.arange(50)),
                                  jsamplers.radical_inverse(3, np.arange(50)))


@pytest.mark.parametrize("nx,ny", [(1, 1), (4, 4), (3, 5)])
def test_stratified_offsets_equal_jax(nx, ny):
    got = trng.stratified_offsets(nx, ny, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrng.stratified_offsets(nx, ny)))


@pytest.mark.parametrize("tracer", cli.TRACERS)
def test_cli_each_tracer(tmp_path, tracer, capsys):
    out = str(tmp_path / "o.png")
    assert cli.main(["cornell", "1", tracer, "--size", "16", "--spp", "1", "--depth", "3",
                     "--out", out, "--device", "cpu"]) == 0
    assert os.path.getsize(out) > 0
    assert "pass 1/1:" in capsys.readouterr().out


@pytest.mark.parametrize("scene", ["xml", "obj"])
def test_cli_scene_files(tmp_path, scene, capsys):
    (tmp_path / "t.obj").write_text("v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nv 0 0 1\n"
                                    "f 1 2 3 4\nf 1 2 5\nf 2 3 5\n")
    path = (io_cases.write_media_maps(str(tmp_path)) if scene == "xml"
            else str(tmp_path / "t.obj"))
    out = str(tmp_path / "o.png")
    assert cli.main([path, "1", "PT", "--size", "16", "--spp", "1", "--out", out,
                     "--device", "cpu", "--filter", "gaussian"]) == 0
    assert os.path.getsize(out) > 0


def test_cli_checkpoint_resume_equals_straight(tmp_path):
    def run(n, ck):
        args = ["cornell", str(n), "PT", "--size", "16", "--spp", "2", "--depth", "3",
                "--device", "cpu", "--out", str(tmp_path / "o.png"), "--checkpoint", ck]
        assert cli.main(args) == 0
        return np.load(ck, allow_pickle=True)

    resumed = str(tmp_path / "r.npz")
    first = run(2, resumed)
    assert int(first["leaf_1"]) == 2           # saved after the last pass
    a = run(3, resumed)
    b = run(3, str(tmp_path / "s.npz"))
    assert int(a["leaf_1"]) == int(b["leaf_1"]) == 3
    np.testing.assert_array_equal(a["leaf_0"], b["leaf_0"])
    assert not np.array_equal(first["leaf_0"], b["leaf_0"])


def test_inverse_example_takes_the_tested_step(capsys):
    """examples/inverse_rendering_torch.py at 16x16 on the CPU: its losses are
    `entry.inverse_loss`'s at each step's parameters (the step that
    tests/test_torch_grad.py holds to JAX's jax.value_and_grad)."""
    import importlib.util

    from cudatracerlib_tpu_torch import entry
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                        "inverse_rendering_torch.py")
    spec = importlib.util.spec_from_file_location("inverse_rendering_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    losses = example.main(["--steps", "2", "--size", "16", "--spp", "2", "--device", "cpu"])
    assert len(losses) == 2 and "recovered red wall" in capsys.readouterr().out
    cfg = pt.PTConfig(max_depth=4, rr_start=99)
    start = entry.grey_start(device="cpu")
    with torch.no_grad():
        target = pt.render(cornell_box(device="cpu"), 16, 16, 2, 0, cfg)
    params = (start.textures.color_a, start.lights.radiance)
    for k, loss in enumerate(losses):
        step = entry.inverse_step(start, params, target, k + 1, 16, 16, 2, cfg)
        assert loss == pytest.approx(float(step.loss), rel=1e-6)
        params = step.params
