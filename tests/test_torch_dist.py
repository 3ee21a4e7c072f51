"""Port parity: the distributed depth-banded frame (parallel/) against the
JAX package's `make_distributed_render` on the conftest's CPU mesh.

The port's ranks are spawned once per world size (gloo, one thread each) by
a module fixture that runs every scenario and hands back numpy arrays: each
rank's strip and dropped count or stats, and, at world 4 on the cloud, the
inputs the frame gave `_depth_band_thresholds`, `_bucket_by_destination`
and the 3-key sort.  Held to JAX bit for bit: the plan, the bucketing, the
3-key sort on the received lists, the thresholds, the stats vector and the
dropped count.  Images (JAX's XLA and Pallas-interpret tiers, and the port's
single-device `Renderer`): float |Δ| <= 2e-3 and 8-bit ±1 on each of r, g
and b (docs/TOLERANCES.md; the bands regroup the transmittance products).
"""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_dist import CONFIG
from test_skew import CONFIG as SKEW_CONFIG
from test_skew import _camera, _hot_cloud
from vk3dgaussiansplatting_tpu.core.config import RenderConfig
from vk3dgaussiansplatting_tpu.parallel import dist as jd
from vk3dgaussiansplatting_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from vk3dgaussiansplatting_tpu.render.camera import Camera
from vk3dgaussiansplatting_tpu.scenes.synthetic import SimpleTestGaussiansScene, procedural_cloud_table
from vk3dgaussiansplatting_tpu_torch import Renderer, convert
from vk3dgaussiansplatting_tpu_torch.parallel import dist as td
from vk3dgaussiansplatting_tpu_torch.parallel import mesh as tmesh
from vk3dgaussiansplatting_tpu_torch.parallel import multihost

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FLOAT_TOL = 2e-3


def _scenes():
    """name -> (JAX table, camera, config): test_dist.py's simple scene and
    512-gaussian cloud, test_skew.py's hot cloud."""
    simple = SimpleTestGaussiansScene(aspect=CONFIG.aspect)
    simple.init()
    simple.camera.set_aspect(CONFIG.aspect)
    cam = Camera(CONFIG.aspect)
    cam.set_position((0.0, 0.0, 5.0))
    cam.set_rotation(np.pi, 0.0)
    cloud = procedural_cloud_table(512, seed=7, extent=3.0, scale_log_mean=-2.5)
    return {
        "simple": (simple.gaussians(), simple.camera, CONFIG),
        "cloud": (cloud, cam, CONFIG),
        "hot": (_hot_cloud(), _camera(), SKEW_CONFIG),
    }


SCENES = _scenes()


def _plan(name, world, variant=None):
    table, _cam, config = SCENES[name]
    plan = jd.plan_distribution(config, jd._pad_table(table, world).num_gaussians, world)
    if variant == "slab64":  # an undersized exchange slab: drops (test_skew.py:83)
        plan = plan._replace(slab_capacity=64)
    elif variant == "strip8":  # an undersized strip window (test_skew.py:179)
        plan = plan._replace(strip_capacity=8)
    return plan


# (scene, variant, return_stats, route_features) per rank run; "capture"
# records the frame's inputs to the bit-exact pieces.
JOBS = {
    4: {
        "simple": ("simple", None, False, True),
        "simple_gather": ("simple", None, False, False),
        "cloud": ("cloud", None, True, True),
        "hot": ("hot", None, True, True),
        "hot_slab64": ("hot", "slab64", True, True),
        "hot_strip8": ("hot", "strip8", False, True),
    },
    2: {"hot": ("hot", None, True, True)},
}
CAPTURE = (4, "cloud")


def _rank_jobs(rank, world, outdir):
    """One rank: every job's frame; its strip, output and captures to a file.
    The scenes are rebuilt here from the module (spawn pipes the arguments,
    so they stay small)."""
    torch.set_num_threads(1)
    seen = {}
    for fname in ("_depth_band_thresholds", "_bucket_by_destination", "_sort3"):
        real = getattr(td, fname)

        def spy(*args, _real=real, _name=fname):
            out = _real(*args)
            seen[_name] = (args, out)
            return out

        setattr(td, fname, spy)
    comm = tmesh.Communicator("cpu")
    assert multihost.is_multi_process()
    multihost.assert_group_spans_processes(comm)
    results = {}
    for name, (scene, variant, stats, routed) in JOBS[world].items():
        table, cam, config = SCENES[scene]
        view, proj = cam.matrices()
        shard = td.shard_table(td._pad_table(convert.table_from_jax(table), world), rank, world)
        fn = td.make_distributed_render(
            comm, convert.config_from_jax(config),
            convert.dist_config_from_jax(_plan(scene, world, variant)),
            return_stats=stats, route_features=routed,
        )
        strip, out = fn(shard, view, proj, np.asarray(cam.position, np.float32))
        results[name] = {"strip": strip.numpy(), "out": out.numpy()}
        if (world, name) == CAPTURE:
            (depth, _c, _t), thr = seen["_depth_band_thresholds"]
            (words, dest, _n, _s), slabs = seen["_bucket_by_destination"]
            (tile, depth_r, index, _nt), _sorted = seen["_sort3"]
            results[name]["capture"] = {
                "depth": depth.numpy(), "thr": thr.numpy(), "words": words.numpy(),
                "dest": dest.numpy(), "slabs": slabs.numpy(), "recv": np.stack(
                    [tile.numpy(), depth_r.numpy(), index.numpy()]),
            }
    torch.save(results, f"{outdir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """world -> job -> {"strip": [H_pad, W, 3], "out": [world, ...], and
    "capture" per rank where recorded}."""
    runs = {}
    for world, jobs in JOBS.items():
        outdir = tmp_path_factory.mktemp(f"world{world}")
        multihost.launch(_rank_jobs, world, backend="gloo",
                         init_method=f"file://{outdir}/store", args=(str(outdir),))
        ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False) for r in range(world)]
        runs[world] = {
            name: {
                "strip": np.concatenate([r[name]["strip"] for r in ranks]),
                "out": np.concatenate([r[name]["out"] for r in ranks]),
                "capture": [r[name].get("capture") for r in ranks],
            }
            for name in jobs
        }
    return runs


@functools.lru_cache(maxsize=None)
def _jax_frame(scene, world, variant=None, pallas=False, return_stats=False):
    table, cam, config = SCENES[scene]
    padded = jd._pad_table(table, world)
    fn = jd.make_distributed_render(make_mesh(world), config, _plan(scene, world, variant),
                                    use_pallas_blend=pallas, return_stats=return_stats)
    view, proj = cam.matrices()
    img, out = fn(jax.tree.map(jnp.asarray, padded), jnp.asarray(view), jnp.asarray(proj),
                  jnp.asarray(cam.position, dtype=jnp.float32))
    return np.asarray(img), np.asarray(out)


def _assert_image_close(got, want, what):
    assert got.shape == want.shape, what
    for ch in range(3):
        d = np.abs(got[..., ch] - want[..., ch])
        assert d.max() <= FLOAT_TOL, f"{what} channel {ch}: float max |Δ| {d.max()}"
        q = np.abs(np.round(got[..., ch] * 255.0).astype(np.int32)
                   - np.round(want[..., ch] * 255.0).astype(np.int32))
        assert q.max() <= 1, f"{what} channel {ch}: 8-bit max |Δ| {q.max()}"


def test_plan_distribution_matches_jax():
    for config, n, ndev in [(CONFIG, 16, 4), (CONFIG, 514, 2), (SKEW_CONFIG, 400, 4),
                            (RenderConfig(width=1920, height=1080, capacity_pow_two=False),
                             5_834_784, 4), (RenderConfig(width=1920, height=1080), 5_834_784, 2)]:
        want = jd.plan_distribution(config, n, ndev)
        assert td.plan_distribution(convert.config_from_jax(config), n, ndev) == tuple(want)
        assert convert.dist_config_from_jax(want) == tuple(want)
    # 720p has 45 tile rows: not over 2 or 4 ranks, in either package.
    hd = RenderConfig(width=1280, height=720)
    for ndev in (2, 4):
        with pytest.raises(ValueError, match="grid_height"):
            jd.plan_distribution(hd, 1000, ndev)
        with pytest.raises(ValueError, match="grid_height"):
            td.plan_distribution(convert.config_from_jax(hd), 1000, ndev)


def test_bucket_and_sort3_match_jax(port):
    """`_bucket_by_destination` on the cloud frame's own words and
    destinations, and on a skewed case that overflows its slab; the 3-key
    sort on every rank's received list (whose id order the port's one-key
    stable sort relies on)."""
    bucket = jax.jit(jd._bucket_by_destination, static_argnums=(2, 3))
    sort3 = jax.jit(jd._sort3)
    rng = np.random.default_rng(3)
    skewed = (rng.integers(-2**31, 2**31, (500, 12)).astype(np.int32),
              np.minimum(rng.geometric(0.4, 500) - 1, 4).astype(np.int64), 4, 40)
    cases = [(c["words"], c["dest"], 4, c["slabs"].shape[1]) for c in port[4]["cloud"]["capture"]]
    for words, dest, ndev, slab in cases + [skewed]:
        want = bucket([jnp.asarray(words[:, j].view(np.uint32)) for j in range(words.shape[1])],
                      jnp.asarray(dest.astype(np.uint32)), ndev, slab)
        got = td._bucket_by_destination(torch.from_numpy(words), torch.from_numpy(dest), ndev, slab)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))
    assert (skewed[1] == 0).sum() > 40  # the skewed case dropped a tail
    for cap in port[4]["cloud"]["capture"]:
        tile, depth, index = cap["recv"]
        want = sort3(*(jnp.asarray(x.astype(np.uint32)) for x in (tile, depth, index)))
        got = td._sort3(*(torch.from_numpy(x) for x in (tile, depth, index)), CONFIG.num_tiles)
        for g, w in zip(got[:3], want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
        assert (tile != 0xFFFFFFFF).sum() > 100


def test_depth_band_thresholds_match_jax(port):
    caps = port[4]["cloud"]["capture"]
    depth = np.concatenate([c["depth"] for c in caps]).astype(np.uint32)
    mesh = make_mesh(4)
    fn = jax.jit(jax.shard_map(lambda d: jd._depth_band_thresholds(d, 4)[None], mesh=mesh,
                               in_specs=P(SHARD_AXIS), out_specs=P(SHARD_AXIS)))
    want = np.asarray(fn(jnp.asarray(depth))).astype(np.int64)  # [4, 3], one row per device
    for r, c in enumerate(caps):
        np.testing.assert_array_equal(c["thr"], want[r])
    assert len(set(want[0].tolist())) == 3


def test_stats_match_jax(port):
    """[live_local, sent_live, recv_live, dropped] per rank, bit for bit, at
    world 4 (cloud, hot cloud, hot cloud with an undersized slab) and at
    world 2 (hot cloud), the dryrun_multichip chain, and each image against
    JAX's (the undersized slab drops the same elements in both)."""
    for world, name, scene, variant in [(4, "cloud", "cloud", None), (4, "hot", "hot", None),
                                        (4, "hot_slab64", "hot", "slab64"), (2, "hot", "hot", None)]:
        want_img, want = _jax_frame(scene, world, variant, return_stats=True)
        got = port[world][name]["out"]
        np.testing.assert_array_equal(got, want.reshape(world, 4).astype(np.int64),
                                      err_msg=f"world {world} {name}")
        _assert_image_close(port[world][name]["strip"], want_img, f"world {world} {name} vs JAX")
        live, sent, recv, dropped = got.T
        assert recv.sum() == sent.sum() and dropped.sum() == 0
        if variant is None:
            assert (sent == live).all() and recv.max() <= 3 * max(recv.min(), 1)
        else:
            assert (sent < live).any()  # the slab dropped elements


def test_strip_window_dropped_matches_jax(port):
    """An 8-slot strip window: the default output's dropped count per rank
    equals JAX's, is > 0, and the image stays finite in [0, 1]."""
    want_img, want = _jax_frame("hot", 4, "strip8")
    got = port[4]["hot_strip8"]
    np.testing.assert_array_equal(got["out"], want.astype(np.int64))
    assert got["out"].sum() > 0
    assert np.isfinite(got["strip"]).all() and 0.0 <= got["strip"].min() <= got["strip"].max() <= 1.0
    _assert_image_close(got["strip"], want_img, "strip8 vs JAX")


@pytest.mark.parametrize("scene", ["simple", "cloud", "hot"])
def test_images_match_jax_and_single_device(port, scene):
    table, cam, config = SCENES[scene]
    stats = scene != "simple"
    run = port[4][scene]
    img = run["strip"]
    dropped = run["out"][:, 3] if stats else run["out"]
    assert dropped.sum() == 0
    for pallas in (False, True):
        want, _ = _jax_frame(scene, 4, pallas=pallas, return_stats=stats)
        _assert_image_close(img, want, f"{scene} vs JAX (pallas={pallas})")
    renderer = Renderer(convert.config_from_jax(config), device="cpu")
    renderer.init_for_scene(convert.table_from_jax(table))
    single = renderer.draw(cam).image.numpy()  # any camera with matrices() and position
    _assert_image_close(img[: config.height, : config.width], single, f"{scene} vs Renderer")
    for ch in range(3):
        assert img[..., ch].max() > 0
    if scene == "simple":  # frame data all-gathered instead of routed: same rows
        np.testing.assert_array_equal(port[4]["simple_gather"]["strip"], img)


def _failing_rank(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    tmesh.Communicator("cpu").all_gather(torch.zeros(1))  # rank 0 waits on rank 1


def test_dist_guards(tmp_path):
    """The backend is never defaulted; the plan must fit the group; a rank
    that raises fails the whole run."""
    with pytest.raises(ValueError, match="explicitly"):
        multihost.initialize(None, f"file://{tmp_path}/a", 0, 1)
    with pytest.raises(ValueError, match="explicitly"):
        multihost.launch(_failing_rank, 2, backend=None, init_method=f"file://{tmp_path}/b")
    multihost.initialize("gloo", f"file://{tmp_path}/c", 0, 1)
    try:
        comm = tmesh.Communicator("cpu")
        multihost.assert_group_spans_processes(comm)
        assert multihost.process_info()["process_count"] == 1
        assert not multihost.is_multi_process()
        config = convert.config_from_jax(CONFIG)
        with pytest.raises(ValueError, match="ranks"):
            td.make_distributed_render(comm, config, td.plan_distribution(config, 16, 4))
    finally:
        torch.distributed.destroy_process_group()
    # Whichever rank's error arrives first (rank 1's, or rank 0's broken
    # connection), the run raises.
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        multihost.launch(_failing_rank, 2, backend="gloo", init_method=f"file://{tmp_path}/d")
    # The distributed tier imports and renders a frame with no JAX at all.
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["vk3dgaussiansplatting_tpu"] = None
        import torch
        torch.set_num_threads(1)
        from vk3dgaussiansplatting_tpu_torch import RenderConfig
        from vk3dgaussiansplatting_tpu_torch.parallel import dist, mesh, multihost
        from vk3dgaussiansplatting_tpu_torch.scenes import synthetic
        cfg = RenderConfig(width=64, height=48, capacity_slack_per_tile=16)
        scene = synthetic.SimpleTestGaussiansScene(aspect=cfg.aspect)
        scene.init()
        multihost.initialize("gloo", "file://{tmp_path}/e", 0, 1)
        plan = dist.plan_distribution(cfg, scene.gaussians().num_gaussians, 1)
        frame = dist.make_distributed_render(mesh.Communicator("cpu"), cfg, plan)
        view, proj = scene.camera.matrices()
        strip, dropped = frame(scene.gaussians(), view, proj, scene.camera.position)
        assert strip.shape == (48, 64, 3) and strip.any() and int(dropped.sum()) == 0
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                       for m, v in sys.modules.items() if v is not None)
        print("OK")
        """
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")
