"""Reader of the reference's checkpoint layout, without JAX.

A checkpoint directory holds ``step_<N>/`` folders, each with:

    manifest.bin   msgpack, zstd-compressed: step, ``tree_template`` (the
                   saved tree as JSON with every leaf replaced by 0), the
                   per-leaf file/dtype/shape list, meta
    a_<i>.npy      leaf i, in ``jax.tree_util`` flatten order: dict keys
                   sorted, lists in order

The leaf order is rebuilt from ``tree_template`` alone; a manifest without
one is refused rather than guessed at. ``msgpack`` and ``zstandard`` are
imported when a manifest is read, so the package imports without them.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


def all_steps(directory: str) -> List[int]:
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


def _step_dir(directory: str, step: Optional[int]) -> Tuple[int, str]:
    if step is None:
        steps = all_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = steps[-1]
    return step, os.path.join(directory, f"step_{step}")


def read_manifest(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Parsed manifest of ``step`` (newest by default), loading no arrays."""
    try:
        import msgpack
        import zstandard
    except ImportError as e:
        raise ImportError(
            "reading a checkpoint manifest needs the 'msgpack' and 'zstandard' "
            f"packages, which are not installed ({e})") from e
    _, d = _step_dir(directory, step)
    with open(os.path.join(d, "manifest.bin"), "rb") as f:
        blob = f.read()
    return msgpack.unpackb(zstandard.ZstdDecompressor().decompress(blob))


def _flatten_order(template: Any, path: Tuple = ()) -> Iterator[Tuple]:
    """Leaf paths of a JSON template in ``jax.tree_util`` flatten order."""
    if isinstance(template, dict):
        for k in sorted(template):
            yield from _flatten_order(template[k], path + (k,))
    elif isinstance(template, list):
        for i, v in enumerate(template):
            yield from _flatten_order(v, path + (i,))
    else:
        yield path


def _unflatten(template: Any, leaves: Dict[Tuple, np.ndarray], path: Tuple = ()) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, path + (k,)) for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten(v, leaves, path + (i,)) for i, v in enumerate(template)]
    return leaves[path]


def restore_numpy(directory: str, step: Optional[int] = None) -> Tuple[Any, Dict]:
    """The saved tree with numpy leaves, plus ``meta`` (with ``step``)."""
    step, d = _step_dir(directory, step)
    manifest = read_manifest(directory, step)
    if "tree_template" not in manifest:
        raise ValueError(f"{d}: manifest has no tree_template; leaf order unknown")
    template = json.loads(manifest["tree_template"])
    paths = list(_flatten_order(template))
    entries = manifest["leaves"]
    if len(paths) != len(entries):
        raise ValueError(f"{d}: manifest lists {len(entries)} leaves, "
                         f"tree_template has {len(paths)}")
    leaves = {}
    for path, e in zip(paths, entries):
        a = np.load(os.path.join(d, e["file"] + ".npy"))
        if list(a.shape) != list(e["shape"]) or str(a.dtype) != e["dtype"]:
            raise ValueError(f"{d}/{e['file']}.npy: {a.dtype}{list(a.shape)} "
                             f"!= manifest {e['dtype']}{e['shape']}")
        leaves[path] = a
    return _unflatten(template, leaves), dict(manifest.get("meta", {}), step=step)
