"""IO layer: PCD/PLY round trips, TUM trajectories, ATE, viz exports."""
import numpy as np
import pytest

from warpsense.io import pcd
from warpsense.io import trajectory as traj
from warpsense.io.dataset import PcdDirectoryDataset, SyntheticDataset
from warpsense.io.pcl_writer import export


def _cloud(n=257, seed=0):
    return np.random.default_rng(seed).normal(0, 5, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_roundtrip(tmp_path, binary):
    c = _cloud()
    pcd.write_pcd(tmp_path / "a.pcd", c, binary=binary)
    got = pcd.read_pcd(tmp_path / "a.pcd")
    np.testing.assert_allclose(got[:, :3], c, atol=1e-5)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_colors", [True, False])
def test_ply_roundtrip(tmp_path, binary, with_colors):
    c = _cloud(101)
    colors = (np.random.default_rng(1).uniform(0, 255, (101, 3))
              .astype(np.uint8) if with_colors else None)
    pcd.write_ply(tmp_path / "a.ply", c, colors, binary=binary)
    got = pcd.read_ply(tmp_path / "a.ply")
    np.testing.assert_allclose(got, c, atol=1e-5)


def test_pcd_intensity_column(tmp_path):
    c = np.concatenate([_cloud(64), np.ones((64, 1), np.float32)], axis=1)
    pcd.write_pcd(tmp_path / "i.pcd", c)
    got = pcd.read_pcd(tmp_path / "i.pcd")
    assert got.shape == (64, 4)
    np.testing.assert_allclose(got, c, atol=1e-5)


def _poses(n=10, seed=2):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        th = rng.uniform(-0.5, 0.5)
        c, s = np.cos(th), np.sin(th)
        poses[i][:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        poses[i][:3, 3] = rng.uniform(-10, 10, 3)
    return poses


def test_tum_roundtrip(tmp_path):
    poses = _poses()
    traj.write_tum(tmp_path / "t.tum", poses)
    stamps, got = traj.read_tum(tmp_path / "t.tum")
    assert len(stamps) == len(poses)
    np.testing.assert_allclose(got, poses, atol=1e-4)


def test_ate_zero_for_identical():
    poses = _poses()
    assert traj.ate_rmse(poses, poses) < 1e-9


def test_ate_alignment_removes_rigid_offset():
    poses = _poses()
    T = np.eye(4)
    th = 0.3
    T[:3, :3] = [[np.cos(th), -np.sin(th), 0],
                 [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    T[:3, 3] = [5.0, -2.0, 1.0]
    moved = np.einsum("ij,njk->nik", T, poses)
    assert traj.ate_rmse(moved, poses, align=False) > 1.0
    assert traj.ate_rmse(moved, poses, align=True) < 1e-6


def test_synthetic_dataset_and_export_roundtrip(tmp_path):
    ds = SyntheticDataset(3, channels=8, columns=64)
    n = export(ds, tmp_path / "clouds", "pcd")
    assert n == 3
    back = PcdDirectoryDataset(tmp_path / "clouds",
                               tum_ground_truth=tmp_path / "clouds"
                               / "ground_truth.tum")
    frames = list(back)
    assert len(frames) == 3
    assert frames[0].cloud.shape[1] == 3
    assert frames[0].ground_truth is not None


def test_tsdf_viz_export(tmp_path):
    import jax.numpy as jnp

    from warpsense.map.local_map import LocalMapState
    from warpsense.obs.viz import export_tsdf_ply, window_skeleton

    size = (11, 11, 11)
    value = np.full(size, 600, np.int16)
    weight = np.zeros(size, np.int16)
    value[5, 5, 5] = 30
    weight[5, 5, 5] = 64
    value[2, 3, 4] = -100
    weight[2, 3, 4] = 32
    state = LocalMapState(jnp.asarray(value), jnp.asarray(weight),
                          jnp.zeros(3, jnp.int32),
                          jnp.asarray([5, 5, 5], jnp.int32))
    n = export_tsdf_ply(tmp_path / "map.ply", state, resolution=64, tau=600)
    assert n == 2
    from warpsense.io.pcd import read_ply
    pts = read_ply(tmp_path / "map.ply")
    # cell (5,5,5) array == global (0,0,0) (pos=0, offset=center)
    assert any(np.allclose(p, [0.032, 0.032, 0.032], atol=1e-5) for p in pts)
    sk = window_skeleton(state, resolution=64)
    assert sk.shape[1] == 3 and len(sk) == 12 * 32


# ------------------------------------------------------------------- lz4
def _lz4_literal_block(data: bytes) -> bytes:
    """Craft a valid literals-only LZ4 block (with length extension)."""
    lit = len(data)
    if lit < 15:
        return bytes([lit << 4]) + data
    out = bytearray([0xF0])
    rem = lit - 15
    while rem >= 255:
        out.append(255)
        rem -= 255
    out.append(rem)
    return bytes(out) + data


def _lz4_frame(blocks, uncompressed=False) -> bytes:
    """Craft a standard LZ4 frame around raw block payloads."""
    import struct
    out = bytearray(struct.pack("<I", 0x184D2204))
    out += bytes([0x60, 0x40, 0x00])          # FLG v1 indep, BD 64K, HC
    for b in blocks:
        size = len(b) | (0x80000000 if uncompressed else 0)
        out += struct.pack("<I", size) + b
    out += struct.pack("<I", 0)               # EndMark
    return bytes(out)


def test_lz4_block_match_copy():
    """Hand-computed spec vector: literals + overlapping match + tail."""
    from warpsense.io.lz4 import decompress_block

    # token 0x44: 4 literals 'abcd', match offset 4 len 8 (overlapping ->
    # periodic copy), then a final literals-only sequence 'xyz'
    src = b"\x44abcd\x04\x00" + b"\x30xyz"
    dst = bytearray()
    decompress_block(src, dst)
    assert bytes(dst) == b"abcdabcdabcd" + b"xyz"


def test_lz4_frame_roundtrip_paths():
    from warpsense.io.lz4 import decompress

    payload = bytes(range(256)) * 5 + b"tail"
    # compressed literals-only blocks (exercises length extension)
    frame = _lz4_frame([_lz4_literal_block(payload[:700]),
                        _lz4_literal_block(payload[700:])])
    assert decompress(frame) == payload
    # uncompressed-block path
    assert decompress(_lz4_frame([payload], uncompressed=True)) == payload
    # match across linked blocks: block 2's offset reaches block 1
    b1 = _lz4_literal_block(b"abcdefgh")
    b2 = b"\x04\x08\x00" + b""                # 0 literals, match off 8 len 8
    frame = _lz4_frame([b1, b2 + b"\x10Z"])
    assert decompress(frame) == b"abcdefgh" + b"abcdefgh" + b"Z"


def test_lz4_truncated_block_raises():
    """Truncated blocks fail loudly at the source (code-review r4) instead
    of returning short output that garbles downstream record parsing."""
    import pytest
    from warpsense.io.lz4 import decompress_block

    with pytest.raises(ValueError, match="truncated literals"):
        decompress_block(b"\xF0\x20abc", bytearray())   # claims 47 literals
    with pytest.raises(ValueError, match="truncated match"):
        decompress_block(b"\x44abcd\x04", bytearray())  # offset cut short
