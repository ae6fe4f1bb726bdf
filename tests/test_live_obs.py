"""Live observability: monitor hub, file streamer, HTTP endpoint, and the
warpsense pipeline actually publishing while a run is in flight — the role
of the reference's per-scan RViz topics (publish.h:11-93,
visualization/map.h:14-246)."""
import json
import time
import urllib.request

import numpy as np

from warpsense.map.local_map import LocalMapState
from warpsense.obs.live import FileStreamer, HttpMonitor, LiveMonitor


def _state(size=(9, 9, 9), tau=600):
    v = np.full(size, tau, np.int16)
    w = np.zeros(size, np.int16)
    v[4, 4, 4] = 30
    w[4, 4, 4] = 64
    return LocalMapState(value=v, weight=w,
                         pos=np.zeros(3, np.int32),
                         offset=np.asarray([s // 2 for s in size], np.int32))


def test_monitor_pubsub_and_snapshots():
    mon = LiveMonitor()
    got = []
    mon.subscribe("pose", lambda s, p: got.append(s))
    pose = np.eye(4)
    pose[:3, 3] = [1000.0, 2000.0, 0.0]
    mon.publish_pose(0.1, pose)
    mon.publish_pose(0.2, pose)
    assert got == [0.1, 0.2]
    st = json.loads(mon.status_json())
    assert st["scans"] == 2 and st["position_m"][0] == 1.0
    tum = mon.tum_path().strip().splitlines()
    assert len(tum) == 2 and tum[0].startswith("0.1")

    mon.publish_map(_state(), resolution=64, tau=600)
    ply = mon.map_ply_bytes()
    assert ply.startswith(b"ply") and b"vertex" in ply

    mon.publish_shift([10, 0, 0])
    assert json.loads(mon.status_json())["shifts"] == 1


def test_file_streamer(tmp_path):
    mon = LiveMonitor()
    fs = FileStreamer(mon, tmp_path, map_period_s=0.0, path_period_s=0.0)
    mon.publish_pose(0.1, np.eye(4))
    mon.publish_map(_state(), resolution=64, tau=600)
    fs.flush()
    assert (tmp_path / "latest_path.tum").exists()
    assert (tmp_path / "status.json").exists()
    assert (tmp_path / "latest_map.ply").read_bytes().startswith(b"ply")


def test_http_monitor():
    mon = LiveMonitor()
    mon.publish_pose(0.5, np.eye(4), timing_ms=12.5)
    mon.publish_map(_state(), resolution=64, tau=600)
    http = HttpMonitor(mon)
    try:
        base = f"http://127.0.0.1:{http.port}"
        st = json.loads(urllib.request.urlopen(base + "/status").read())
        assert st["scans"] == 1 and st["scan_ms"] == 12.5
        tum = urllib.request.urlopen(base + "/path.tum").read().decode()
        assert tum.startswith("0.5")
        ply = urllib.request.urlopen(base + "/map.ply").read()
        assert ply.startswith(b"ply")
    finally:
        http.close()


def test_warpsense_publishes_live(tmp_path):
    """A short pipeline run streams pose/map/status through the monitor
    WHILE running (not only at shutdown)."""
    from warpsense.eval.slam_eval import default_params
    from warpsense.io.dataset import SyntheticDataset
    from warpsense.pipeline.warpsense import WarpsenseApp

    mon = LiveMonitor()
    seen_during_run = []
    mon.subscribe("pose", lambda s, p: seen_during_run.append(len(mon.path)))
    params = default_params(32, 256)
    app = WarpsenseApp(params, map_path=tmp_path / "m", capacity=8192,
                       monitor=mon)
    for fr in SyntheticDataset(4, channels=32, columns=256):
        app.cloud_callback(fr.cloud, fr.stamp)
    app.terminate()
    assert seen_during_run == [1, 2, 3, 4]       # streamed per scan
    st = json.loads(mon.status_json())
    assert st["scans"] == 4 and st["map_epoch"] >= 1
    assert mon.map_ply_bytes().startswith(b"ply")
