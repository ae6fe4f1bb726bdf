"""Rosbag1 ingestion: container round-trip, organized reconstruction,
Madgwick filtering, and a bag-driven end-to-end pipeline run.

The reference consumes rosbags of an OS1-128 through ROS playback
(launch/warpsense.launch, README.md:262-279); io/rosbag.py replaces that
path without a ROS dependency.  No sensor data ships with either repo, so
the end-to-end test synthesizes a bag from the analytic box world, then
drives the full pipeline from the BAG BYTES (container parse -> organized
scans -> SLAM -> ATE).
"""
import bz2
import struct

import numpy as np
import pytest

from warpsense.io.rosbag import (BagWriter, ImuMsg, PointCloud2,
                                 RosbagDataset, bag_to_npz, destagger,
                                 organize_cloud, read_bag)
from warpsense.utils.imu import ImuSample, MadgwickFilter


def test_bag_roundtrip(tmp_path):
    p = tmp_path / "t.bag"
    cloud = np.random.default_rng(0).random((8, 16, 3)).astype(np.float32)
    with BagWriter(p) as w:
        w.write_imu("/imu", 0.05, [0, 0, 0, 1], [0.1, -0.2, 0.3],
                    [0, 0, 9.81])
        w.write_pointcloud2("/pts", 0.1, cloud)
    msgs = list(read_bag(p))
    assert [m.datatype for m in msgs] == ["sensor_msgs/Imu",
                                          "sensor_msgs/PointCloud2"]
    imu = msgs[0].msg
    assert isinstance(imu, ImuMsg)
    np.testing.assert_allclose(imu.angular_velocity, [0.1, -0.2, 0.3])
    pc = msgs[1].msg
    assert isinstance(pc, PointCloud2)
    np.testing.assert_array_equal(pc.xyz(), cloud)
    assert abs(pc.stamp - 0.1) < 1e-6


def test_bag_bz2_chunk(tmp_path):
    """Reader handles bz2-compressed chunks (the common bag compression)."""
    src = tmp_path / "plain.bag"
    cloud = np.ones((2, 4, 3), np.float32)
    with BagWriter(src) as w:
        w.write_pointcloud2("/pts", 1.5, cloud)
    raw = src.read_bytes()
    # steal the message+connection records (everything after the bag header
    # record) and re-wrap them into one bz2 chunk record
    magic = b"#ROSBAG V2.0\n"
    body = raw[len(magic):]
    (h1,) = struct.unpack_from("<I", body, 0)
    (d1,) = struct.unpack_from("<I", body, 4 + h1)
    rest = body[4 + h1 + 4 + d1:]
    comp = bz2.compress(rest)
    hdr = b""
    for k, v in {b"op": b"\x05", b"compression": b"bz2",
                 b"size": struct.pack("<I", len(rest))}.items():
        f = k + b"=" + v
        hdr += struct.pack("<I", len(f)) + f
    out = (magic + body[:4 + h1 + 4 + d1]
           + struct.pack("<I", len(hdr)) + hdr
           + struct.pack("<I", len(comp)) + comp)
    dst = tmp_path / "bz2.bag"
    dst.write_bytes(out)
    msgs = list(read_bag(dst))
    assert len(msgs) == 1
    np.testing.assert_array_equal(msgs[0].msg.xyz(), cloud)


def test_organize_and_destagger():
    H, W = 8, 32
    el = np.radians(np.linspace(20, -20, H))
    az = np.linspace(-np.pi, np.pi, W, endpoint=False)
    r = 5.0
    grid = np.stack([
        r * np.cos(el)[:, None] * np.cos(az)[None, :],
        r * np.cos(el)[:, None] * np.sin(az)[None, :],
        r * np.sin(el)[:, None] * np.ones((1, W))], axis=-1)
    ring = np.repeat(np.arange(H), W)
    org = organize_cloud(grid.reshape(-1, 3).astype(np.float32), ring, H, W)
    # every beam lands back on its own (ring, col) cell
    filled = (org != 0).any(-1)
    assert filled.all()
    np.testing.assert_allclose(org, grid, atol=1e-5)

    shifts = np.arange(H) % 4
    staggered = np.stack([np.roll(org[i], shifts[i], axis=0)
                          for i in range(H)])
    np.testing.assert_allclose(destagger(staggered, shifts), org)


def test_madgwick_static_gravity():
    f = MadgwickFilter()
    q = f.update(0.0, [0, 0, 0], [0, 0, 9.81])
    np.testing.assert_allclose(q, [0, 0, 0, 1], atol=1e-9)
    for i in range(1, 50):
        q = f.update(i * 0.01, [0, 0, 0], [0, 0, 9.81])
    np.testing.assert_allclose(q, [0, 0, 0, 1], atol=1e-6)


def test_madgwick_gyro_integration():
    f = MadgwickFilter(beta=0.0)       # pure gyro
    f.update(0.0, [0, 0, 0], [0, 0, 0])
    wz = np.pi / 2                     # 90 deg/s about z
    for i in range(1, 101):
        q = f.update(i * 0.01, [0, 0, wz], [0, 0, 0])
    # one second -> 90 deg yaw: q = [0, 0, sin(45), cos(45)]
    np.testing.assert_allclose(np.abs(q), [0, 0, np.sin(np.pi / 4),
                                           np.cos(np.pi / 4)], atol=5e-3)


def test_madgwick_gravity_pulls_back():
    f = MadgwickFilter(beta=0.5)
    f.update(0.0, [0, 0, 0], [0, 0, 9.81])
    # inject gyro noise that tilts the estimate, then hold static
    for i in range(1, 30):
        f.update(i * 0.01, [0.8, 0, 0], [0, 0, 9.81])
    for i in range(30, 600):
        q = f.update(i * 0.01, [0, 0, 0], [0, 0, 9.81])
    # gravity observation corrects roll/pitch back to level
    from warpsense.utils.imu import _quat_to_mat_np
    R = _quat_to_mat_np(q)
    assert abs(R[2, 2] - 1.0) < 1e-3


def test_madgwick_raw_samples_into_fastsense_shape():
    f = MadgwickFilter()
    s = f.filter_sample(ImuSample(0.0, np.asarray([0.0, 0, 0])),
                        [0, 0, 9.81])
    assert s.orientation is not None and abs(
        np.linalg.norm(s.orientation) - 1) < 1e-9


def test_bag_driven_warpsense_e2e(tmp_path):
    """Synthesize a bag from the box world, run warpsense FROM THE BAG,
    assert the trajectory tracks ground truth."""
    from warpsense.eval.slam_eval import (default_params, run_warpsense)
    from warpsense.io.dataset import SyntheticDataset

    CH, COLS = 32, 256
    synth = SyntheticDataset(8, channels=CH, columns=COLS)
    bag = tmp_path / "seq.bag"
    gt = []
    with BagWriter(bag) as w:
        for fr in synth:
            w.write_pointcloud2("/os_cloud_node/points", fr.stamp + 1e-3,
                                fr.cloud)
            gt.append(fr.ground_truth)
    frames = list(RosbagDataset(bag, "/os_cloud_node/points",
                                channels=CH, columns=COLS))
    assert len(frames) == 8 and frames[0].cloud.shape == (CH, COLS, 3)
    for fr, g in zip(frames, gt):
        fr.ground_truth = g
    params = default_params(CH, COLS)
    stats = run_warpsense(frames, params, tmp_path / "m", capacity=8192)
    assert stats["frames"] == 8
    assert stats["ate_rmse_m"] < 0.3, stats


def test_bag_driven_featsense_e2e(tmp_path):
    """Featsense (organized-scan front end) runs from bag bytes — the
    ingestion the reference needs ROS playback for."""
    from warpsense.eval.slam_eval import (default_params, run_featsense)
    from warpsense.io.dataset import SyntheticDataset

    CH, COLS = 32, 256
    synth = SyntheticDataset(6, channels=CH, columns=COLS)
    bag = tmp_path / "seq.bag"
    gt = []
    with BagWriter(bag) as w:
        for fr in synth:
            w.write_pointcloud2("/os_cloud_node/points", fr.stamp + 1e-3,
                                fr.cloud)
            gt.append(fr.ground_truth)
    frames = list(RosbagDataset(bag, "/os_cloud_node/points",
                                channels=CH, columns=COLS))
    for fr, g in zip(frames, gt):
        fr.ground_truth = g
    params = default_params(CH, COLS)
    stats = run_featsense(frames, params, tmp_path / "m",
                          edge_capacity=1024, surf_capacity=2048,
                          cloud_capacity=8192)
    assert stats["frames"] == 6
    assert stats["ate_rmse_m"] < 0.5, stats


def test_bag_to_npz(tmp_path):
    bag = tmp_path / "c.bag"
    cloud = np.random.default_rng(1).random((4, 8, 3)).astype(np.float32)
    with BagWriter(bag) as w:
        w.write_imu("/imu", 0.01, [0, 0, 0, 1], [0, 0, 0.1], [0, 0, 9.8])
        w.write_pointcloud2("/pts", 0.1, cloud)
        w.write_pointcloud2("/pts", 0.2, cloud)
    n = bag_to_npz(bag, tmp_path / "c.npz", "/pts", "/imu")
    assert n == 2
    z = np.load(tmp_path / "c.npz")
    assert z["clouds"].shape == (2, 4, 8, 3)
    assert z["imu_angular"].shape == (1, 3)


def test_bag_lz4_chunk(tmp_path):
    """Reader handles lz4-compressed chunks (rosbag record --lz4, the
    common Ouster recording mode) via the pure-Python frame decoder."""
    from test_io import _lz4_frame, _lz4_literal_block

    src = tmp_path / "plain2.bag"
    cloud = np.full((2, 4, 3), 2.0, np.float32)
    with BagWriter(src) as w:
        w.write_pointcloud2("/pts", 2.5, cloud)
    raw = src.read_bytes()
    magic = b"#ROSBAG V2.0\n"
    body = raw[len(magic):]
    (h1,) = struct.unpack_from("<I", body, 0)
    (d1,) = struct.unpack_from("<I", body, 4 + h1)
    rest = body[4 + h1 + 4 + d1:]
    comp = _lz4_frame([_lz4_literal_block(rest[:100]),
                       _lz4_literal_block(rest[100:])])
    hdr = b""
    for k, v in {b"op": b"\x05", b"compression": b"lz4",
                 b"size": struct.pack("<I", len(rest))}.items():
        f = k + b"=" + v
        hdr += struct.pack("<I", len(f)) + f
    out = (magic + body[:4 + h1 + 4 + d1]
           + struct.pack("<I", len(hdr)) + hdr
           + struct.pack("<I", len(comp)) + comp)
    dst = tmp_path / "lz4.bag"
    dst.write_bytes(out)
    msgs = list(read_bag(dst))
    assert len(msgs) == 1
    np.testing.assert_array_equal(msgs[0].msg.xyz(), cloud)
