"""Merge per-process maps from a multi-host run into one map, and export a
map to the reference's HDF5 layout.

A multi-process ``ShardedWarpsenseApp`` run persists one map directory per
host (``<name>.p<rank>``), each holding exactly the voxels that host's
devices own (host-slab-scoped IO, pipeline/warpsense_sharded.py).  This
tool folds them into a single map consumable by the same tooling as a
single-chip run:

    python -m warpsense.eval.merge_maps run.p0 run.p1 -o run

An output path ending in ``.h5`` is written in the reference's HDF5 schema
instead (``/map/x_y_z`` uint32 datasets with the meta attributes,
``/poses/<n>/pose``; src/map/hdf5_global_map.cpp), for
LVR2 meshing and the other tools that read it.  That export needs h5py;
nothing else in the package does.  One input and an ``.h5`` output is a
plain export.

Merge rule: per voxel, the FIRST input with a nonzero WEIGHT wins (the
packed uint32 entry is weight<<16 | value; hosts own disjoint voxel
rows, so at most one input has a nonzero weight anywhere).  Poses and
map meta attributes are taken from the first input that has them (every
process writes the identical replicated pose path).

Limitation: maps written with ``map.initial_weight != 0`` are ambiguous
to merge — their untouched voxels carry a nonzero weight and cannot be
told apart from fused data (the pipelines' default initial_weight is 0,
matching the reference).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..map.global_map import GlobalMap


def _merged(inputs):
    """(chunks {tag: uint32[CS^3]}, poses (n, 7), meta dict) of the union."""
    chunks: dict[str, np.ndarray] = {}
    poses = np.zeros((0, 7), np.float32)
    meta: dict = {}
    for src_path in inputs:
        src = GlobalMap(src_path, 0, truncate=False)
        if not meta:
            meta = src.read_meta()
        for tag in src.chunk_tags():
            raw = src.read_chunk(tag)
            cur = chunks.get(tag)
            # first nonzero weight wins
            chunks[tag] = (raw if cur is None
                           else np.where((cur >> 16) != 0, cur, raw))
        if not len(poses):
            poses = src.read_poses()
    return chunks, poses, meta


def _write_hdf5(output, chunks, poses, meta) -> None:
    import h5py

    with h5py.File(output, "w") as out:
        om = out.require_group("map")
        op = out.require_group("poses")
        for k, v in meta.items():
            om.attrs[k] = v
        for tag, raw in chunks.items():
            om.create_dataset(tag, data=raw, dtype=np.uint32)
        for i, p in enumerate(poses):
            op.create_group(str(i)).create_dataset("pose", data=p)


def merge(inputs, output) -> dict:
    inputs = [Path(p) for p in inputs]
    chunks, poses, meta = _merged(inputs)
    if Path(output).suffix == ".h5":
        _write_hdf5(output, chunks, poses, meta)
    else:
        gm = GlobalMap(output, 0, truncate=True, meta=meta)
        for tag, raw in chunks.items():
            gm._store(tuple(int(c) for c in tag.split("_")), raw)
        for p in poses:
            gm.write_pose(p[:3], p[3:])
        gm.close()
    return {"inputs": len(inputs), "chunks": len(chunks),
            "poses": len(poses)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("inputs", nargs="+", help="per-process map directories")
    ap.add_argument("-o", "--output", required=True,
                    help="merged map directory, or an .h5 file")
    args = ap.parse_args(argv)
    print(json.dumps(merge(args.inputs, args.output)))


if __name__ == "__main__":
    main()
