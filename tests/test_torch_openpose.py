"""The port's OpenPose (`models.openpose`, `data.openpose_detect`,
`data.pose`, `cli.detect_pose`) against the JAX package's on the CPU: the
body, hand and face nets on the same synthetic reference-layout state dicts
(fp32, 2e-4), the detector end to end, the renderer bit for bit, and a CLI
smoke run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from magicdance_tpu.data import pose as jpose
from magicdance_tpu.models import openpose as JO
from magicdance_tpu_torch.data import pose as tpose
from magicdance_tpu_torch.models import openpose as TO
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

NETS = {
    "body": (TO.BodyPoseNet, TO.convert_body_pose, JO.BodyPoseNet, JO.convert_body_pose),
    "hand": (TO.HandPoseNet, TO.convert_hand_pose, JO.HandPoseNet, JO.convert_hand_pose),
    "face": (TO.FacePoseNet, TO.convert_face_pose, JO.FacePoseNet, JO.convert_face_pose),
}


class _Echo(dict):
    """Every key maps to itself: a converter run on it returns {port key:
    reference key}."""

    def __getitem__(self, key):
        return key


def synth_state(name: str, seed: int) -> dict:
    """A synthetic `body_pose_model.pth` / `hand_pose_model.pth` /
    `facenet.pth`-layout state dict (numpy fp32): He-scaled weights, so the
    maps stay O(1) through the stages, and N(0, 0.1^2) biases."""
    make, convert = NETS[name][:2]
    shapes = {k: tuple(v.shape) for k, v in make().state_dict().items()}
    rs = np.random.RandomState(seed)
    out = {}
    for port, ref in sorted(convert(_Echo()).items()):
        shape = shapes[port]
        if port.endswith(".weight"):
            a = rs.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        else:
            a = 0.1 * rs.standard_normal(shape)
        out[ref] = a.astype(np.float32)
    return out


def port_net(name: str, sd: dict):
    net = NETS[name][0]()
    net.load_state_dict(NETS[name][1]({k: torch.from_numpy(v) for k, v in sd.items()}),
                        strict=True)
    return net.eval()


@pytest.mark.parametrize("name", ["body", "hand", "face"])
def test_nets_match_jax(name):
    """64x64 and 70x45 (the floor-mode pools: 70 -> 35 -> 17 -> 8, 45 -> 22
    -> 11 -> 5)."""
    sd = synth_state(name, seed=len(name))
    net = port_net(name, sd)
    jnet = NETS[name][2]()
    params = {"params": jax.tree.map(jnp.asarray, NETS[name][3](sd))}
    apply = jax.jit(jnet.apply)
    for i, (h, w) in enumerate(((64, 64), (70, 45))):
        x = np.random.RandomState(i).uniform(-0.5, 0.5, (1, h, w, 3)).astype(np.float32)
        want = apply(params, jnp.asarray(x))
        want = want if isinstance(want, tuple) else (want,)
        with torch.no_grad():
            got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, wv in zip(got, want):
            wv = np.asarray(wv)
            assert g.shape[2:] == wv.shape[1:3] == (h // 8, w // 8)
            assert float(np.abs(wv).max()) > 0.1  # the maps carry signal
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), wv,
                                       atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """The port's detector (from reference-layout files, on the CPU) and the
    JAX detector, body and hand nets from the same synthetic weights."""
    from magicdance_tpu.data.openpose_detect import OpenposeDetector as JDetector
    from magicdance_tpu_torch.data.openpose_detect import OpenposeDetector

    root = tmp_path_factory.mktemp("weights")
    paths, jdet = {}, JDetector()
    for name, seed in (("body", 0), ("hand", 1)):
        sd = synth_state(name, seed)
        paths[name] = str(root / f"{name}_pose_model.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths[name])
        jdet.params[name] = {"params": jax.tree.map(jnp.asarray, NETS[name][3](sd))}
    det = OpenposeDetector(paths["body"], paths["hand"], device="cpu")
    return det, jdet


def test_detector_matches_jax(detectors):
    """Same candidates (within 1e-3 px and score), same people, same hand
    keypoints on a seeded image. Faces are compared by `face_roi` alone:
    the JAX copy calls `ndarray.ptp`, which NumPy 2 removed."""
    det, jdet = detectors
    img = (np.random.RandomState(3).rand(96, 48, 3) * 255).astype(np.uint8)
    cand, subset = det.detect_body(img)
    jcand, jsubset = jdet.detect_body(img)
    assert cand.shape == jcand.shape and len(cand) > 0
    np.testing.assert_allclose(cand, jcand, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(subset[:, :-2], jsubset[:, :-2])
    np.testing.assert_allclose(subset[:, -2:], jsubset[:, -2:], atol=1e-3, rtol=0)

    res = det(img, include_hands=True, include_faces=False)
    jres = jdet(img, include_hands=True, include_faces=False)
    np.testing.assert_array_equal(res.body, jres.body)
    assert (res.hands is None) == (jres.hands is None)
    if res.hands is not None:
        np.testing.assert_array_equal(res.hands, jres.hands)


def test_face_roi_and_hand_rois():
    from magicdance_tpu.data.openpose_detect import OpenposeDetector as JDetector
    from magicdance_tpu_torch.data.openpose_detect import OpenposeDetector

    cand = np.array([[10, 10, 1, 0], [20, 12, 1, 1], [15, 30, 1, 2], [40, 50, 1, 3],
                     [45, 70, 1, 4], [50, 90, 1, 5]], np.float32)
    person = -np.ones(20, np.float32)
    person[[0, 14, 15]] = [0, 1, 2]
    # nose + two eyes: width 3 x max(10, 20, 20) = 60 around (15, 17.33)
    assert OpenposeDetector.face_roi(cand, person, 100, 100) == (0, 0, 60)
    person[[5, 6, 7]] = [3, 4, 5]
    assert (OpenposeDetector.hand_rois(cand, person[None], 100, 100)
            == JDetector.hand_rois(cand, person[None], 100, 100))
    one = -np.ones(20, np.float32)
    one[0] = 0
    assert OpenposeDetector.face_roi(cand, one, 100, 100) is None


def test_draw_pose_bit_equal_to_jax():
    rs = np.random.RandomState(4)
    body = rs.uniform(0.05, 0.95, (2, 18, 2)).astype(np.float32)
    body[0, [3, 9]] = -1
    hands = rs.uniform(0.1, 0.9, (2, 21, 2)).astype(np.float32)
    hands[1, 5] = -1
    faces = rs.uniform(0.2, 0.8, (1, 70, 2)).astype(np.float32)
    for kw in (dict(body=body, hands=hands, faces=faces), dict(body=body),
               dict(body=body[:0])):
        got = tpose.draw_pose(tpose.PoseResult(**kw), 96, 80)
        want = jpose.draw_pose(jpose.PoseResult(**kw), 96, 80)
        assert got.dtype == np.uint8 and got.shape == (96, 80, 3)
        np.testing.assert_array_equal(got, want)
        assert tpose.keypoint_quality(tpose.PoseResult(**kw)) == jpose.keypoint_quality(
            jpose.PoseResult(**kw))


def test_cli_detect_pose_smoke(tmp_path):
    import json
    import os

    from magicdance_tpu_torch.cli.detect_pose import main

    rs = np.random.RandomState(5)
    for v in ("vid0", "vid1"):
        (tmp_path / "frames" / v).mkdir(parents=True)
        Image.fromarray((rs.rand(48, 24, 3) * 255).astype(np.uint8)).save(
            tmp_path / "frames" / v / "0000.png")
    weights = tmp_path / "body_pose_model.pth"
    torch.save({k: torch.from_numpy(v) for k, v in synth_state("body", 0).items()}, weights)
    out = tmp_path / "poses"
    argv = ["--input", str(tmp_path / "frames"), "--output", str(out), "--body_weights",
            str(weights), "--save_keypoints", "--min_keypoints", "0"]
    main(argv + ["--device", "cpu"])
    for v in ("vid0", "vid1"):
        assert sorted(os.listdir(out / v)) == ["0000.png", "0000.png.json"]
        assert np.asarray(Image.open(out / v / "0000.png")).shape == (48, 24, 3)
        kp = json.load(open(out / v / "0000.png.json"))
        assert kp["hands"] is None and all(len(p) == 18 for p in kp["body"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
