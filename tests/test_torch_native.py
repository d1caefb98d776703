"""The port's native C++ batch loader (`data/native.py`) and the dataset's
native batch path (`data/tiktok.py`) against the JAX package's.

The port builds the repo's `native/image_core.cpp` into its own `_build/`
and the JAX package into `native/`: where both build, the two libraries give
the same floats bit for bit on the same files and seeds, and so do the PIL
paths (the JAX package's behaviour without its library). `rrc_params`
replicates the C++ crop derivation; `TikTokPairDataset.batches` gives JAX's
batches for one seed on either path. The build runs under a lock: parallel
builds leave one library, and none of them writes into `native/`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import magicdance_tpu.data.native as JN
import magicdance_tpu_torch.data.native as TN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frames(tmp_path, n=4):
    rs = np.random.RandomState(0)
    paths = []
    for i in range(n):
        h, w = 60 + 7 * i, 80 - 5 * i
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([(x * 3 + i * 20) % 256, (y * 4) % 256, (x + y) % 256], -1)
        img = (img + rs.randint(0, 30, img.shape)).clip(0, 255).astype(np.uint8)
        p = tmp_path / f"{i}.{'png' if i % 2 else 'jpg'}"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    return paths


def without_lib(mod):
    """Context: `mod`'s loaders take their PIL path."""
    class Ctx:
        def __enter__(self):
            self.saved = mod._LIB, mod._TRIED
            mod._LIB, mod._TRIED = None, True

        def __exit__(self, *exc):
            mod._LIB, mod._TRIED = self.saved
    return Ctx()


def need_both():
    if not TN.native_available():
        pytest.skip(f"the port's native loader did not build: {TN.describe()}")
    if not JN.native_rrc_available():
        pytest.skip("the JAX package's native loader is not built")


def test_port_library_equals_jax_library_bit_for_bit(tmp_path):
    need_both()
    paths = frames(tmp_path)
    assert TN.status()["path"] == "native"
    assert str(TN.library_path()).startswith(os.path.join(ROOT, "magicdance_tpu_torch",
                                                          "_build"))
    for size, crop in ((32, True), (24, False)):
        np.testing.assert_array_equal(TN.batch_load_images(paths, size, crop),
                                      JN.batch_load_images(paths, size, crop))
    np.testing.assert_array_equal(
        TN.batch_load_images(paths, 16, scale=1 / 255, offset=0.0),
        JN.batch_load_images(paths, 16, scale=1 / 255, offset=0.0))
    seeds = [0, 7, 12345, 2 ** 40 + 3]
    for rng_scale in ((0.9, 1.0), (0.5, 0.8)):
        np.testing.assert_array_equal(TN.batch_load_images_rrc(paths, 32, seeds, rng_scale),
                                      JN.batch_load_images_rrc(paths, 32, seeds, rng_scale))
    with pytest.raises(IOError):
        TN.batch_load_images(paths + ["/nonexistent/x.jpg"], 16)


def test_pil_paths_equal_jax(tmp_path):
    paths = frames(tmp_path)
    with without_lib(TN), without_lib(JN):
        np.testing.assert_array_equal(TN.batch_load_images(paths, 32),
                                      JN.batch_load_images(paths, 32))
        np.testing.assert_array_equal(TN.batch_load_images_rrc(paths, 32, [3, 4, 5, 6]),
                                      JN.batch_load_images_rrc(paths, 32, [3, 4, 5, 6]))


def test_rrc_params_replica(tmp_path):
    """The Python replica equals JAX's on many seeds and sizes, and the
    native crops follow it (JAX's test bound: block means within 3 levels,
    the PIL path within 0.05 mean absolute)."""
    for seed in list(range(50)) + [2 ** 31 - 1, 2 ** 40 + 5]:
        for h, w in ((60, 80), (512, 512), (31, 97)):
            for sc in ((0.9, 1.0), (0.5, 1.0), (0.08, 1.0)):
                assert TN.rrc_params(seed, h, w, sc) == JN.rrc_params(seed, h, w, sc)
    if not TN.native_available():
        pytest.skip(TN.describe())
    p = frames(tmp_path)[1]
    img = np.asarray(Image.open(p).convert("RGB"))
    for seed in (0, 1, 12345, 2 ** 30):
        out = TN.batch_load_images_rrc([p], 32, [seed], scale_range=(0.5, 1.0))
        top, left, side = TN.rrc_params(seed, *img.shape[:2], (0.5, 1.0))
        crop = img[top:top + side, left:left + side].astype(np.float32)
        assert abs(((out[0] + 1.0) * 127.5).mean() - crop.mean()) < 3.0
    with without_lib(TN):
        fb = TN.batch_load_images_rrc([p], 32, [12345], scale_range=(0.5, 1.0))
    nv = TN.batch_load_images_rrc([p], 32, [12345], scale_range=(0.5, 1.0))
    assert float(np.abs(fb - nv).mean()) < 0.05


def tiktok_tree(root, pose_size=None):
    rs = np.random.RandomState(0)
    for v in ("v0", "v1"):
        for d in ("train_set", "pose_map_train_set"):
            (root / d / v).mkdir(parents=True)
        for i in range(3):
            y, x = np.mgrid[0:48, 0:48]
            img = np.stack([(x * 5 + i * 40) % 256, (y * 5) % 256,
                            (x + y + i * 30) % 256], -1).astype(np.uint8)
            img = (img + rs.randint(0, 30, img.shape)).clip(0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / "train_set" / v / f"{i:04d}.png")
            pose = img if pose_size is None else np.asarray(
                Image.fromarray(img).resize((pose_size, pose_size)))
            Image.fromarray(pose).save(root / "pose_map_train_set" / v / f"{i:04d}.png")
    # a monochrome frame, which the resampling must skip
    Image.fromarray(np.full((48, 48, 3), 128, np.uint8)).save(root / "train_set" / "v1" /
                                                              "0003.png")
    Image.fromarray(np.full((48, 48, 3), 128, np.uint8)).save(
        root / "pose_map_train_set" / "v1" / "0003.png")


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_dataset_batches_equal_jax(tmp_path, use_native):
    from magicdance_tpu.data.tiktok import TikTokPairDataset as JD
    from magicdance_tpu_torch.data.tiktok import TikTokPairDataset as TD

    if use_native:
        need_both()
    tiktok_tree(tmp_path)
    got_it = TD(root=str(tmp_path), image_size=32, seed=3).batches(3, use_native=use_native)
    want_it = JD(root=str(tmp_path), image_size=32, seed=3).batches(3, use_native=use_native)
    for _ in range(3):
        got, want = next(got_it), next(want_it)
        assert set(got) == set(want) == {"image", "reference", "pose"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if use_native:  # the pose map shares its target frame's crop
        assert float(np.abs((got["image"] + 1) / 2 - got["pose"]).mean()) < 1e-3


def test_off_sized_pose_maps_take_the_python_path(tmp_path, caplog):
    from magicdance_tpu_torch.data.tiktok import TikTokPairDataset as TD

    tiktok_tree(tmp_path, pose_size=40)
    ds = TD(root=str(tmp_path), image_size=16, seed=1)
    assert not ds._pose_dims_match()
    batch = next(ds.batches(2, use_native=True))
    assert batch["pose"].shape == (2, 16, 16, 3)
    assert "falling back to the Python loader" in caplog.text


BUILD = """
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[2])
import magicdance_tpu_torch.data.native as N
N.BUILD_DIR = Path(sys.argv[1])
print(N.build())
"""


def test_parallel_builds_share_one_library(tmp_path):
    """Three processes build at once into an empty directory under the
    lock: each gets the same library, nothing half-written is left, and
    nothing lands in `native/` (whose only build output is the JAX
    package's `libmdimage.so`, which its own tests may be writing now)."""
    if not TN.toolchain_present():
        pytest.skip("no C++ compiler with the jpeg and png headers")
    native_dir = os.path.join(ROOT, "native")
    jax_outputs = {"libmdimage.so", ".build.lock"}
    before = set(os.listdir(native_dir)) - jax_outputs
    out = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(out), ROOT],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(3)]
    results = [p.communicate(timeout=240)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs), results
    assert len(set(results)) == 1
    assert sorted(f for f in os.listdir(out) if not f.startswith(".")) == \
        [os.path.basename(results[0])]
    assert set(os.listdir(native_dir)) - jax_outputs == before


def test_no_compiler_takes_the_pil_path(tmp_path, monkeypatch):
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(TN, "compiler", lambda: None)
    monkeypatch.setattr(TN, "_LIB", None)
    monkeypatch.setattr(TN, "_TRIED", False)
    monkeypatch.setattr(TN, "_STATUS", {"path": "pil", "reason": "", "build_seconds": None})
    assert not TN.native_available()
    assert TN.status()["path"] == "pil" and "no C++ compiler" in TN.describe()
    out = TN.batch_load_images(frames(tmp_path, 2), 16)
    assert out.shape == (2, 16, 16, 3) and out.min() >= -1.0 and out.max() <= 1.0
