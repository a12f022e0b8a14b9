"""Checkpoints in the reference's layout, without JAX: the writer
(`CheckpointManager`: atomic, async, keep-K) and the readers.

A checkpoint directory holds ``step_<N>/`` folders, each with:

    manifest.bin   msgpack, zstd-compressed (JSON where those packages are
                   missing, as the reference falls back): step, ``treedef``
                   (a structural fingerprint), ``tree_template`` (the saved
                   tree as JSON with every leaf replaced by 0), the per-leaf
                   file/dtype/shape list, meta
    a_<i>.npy      leaf i, in ``jax.tree_util`` flatten order: dict keys
                   sorted, lists and tuples in order, ``None`` no leaf

So each package restores what the other wrote. The leaf order is rebuilt
from ``tree_template`` alone; a manifest without one is refused rather than
guessed at. ``msgpack`` and ``zstandard`` are imported when a manifest is
read or written, so the package imports without them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten

#: The first bytes of a zstd frame: a compressed manifest starts with them.
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _codec():
    """(msgpack, zstandard), or None where either is missing."""
    try:
        import msgpack
        import zstandard
    except ImportError:
        return None
    return msgpack, zstandard


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
    _, d = _step_dir(directory, step)
    with open(os.path.join(d, "manifest.bin"), "rb") as f:
        blob = f.read()
    if not blob.startswith(_ZSTD_MAGIC):
        return json.loads(blob.decode())
    codec = _codec()
    if codec is None:
        raise ImportError("reading a compressed checkpoint manifest needs the 'msgpack' "
                          "and 'zstandard' packages, which are not installed")
    msgpack, zstandard = codec
    return msgpack.unpackb(zstandard.ZstdDecompressor().decompress(blob))


def _flatten_order(template: Any, path: Tuple = ()) -> Iterator[Tuple]:
    """Leaf paths of a JSON template in ``jax.tree_util`` flatten order."""
    if template is None:
        return
    if isinstance(template, dict):
        for k in sorted(template):
            yield from _flatten_order(template[k], path + (k,))
    elif isinstance(template, list):
        for i, v in enumerate(template):
            yield from _flatten_order(v, path + (i,))
    else:
        yield path


def _unflatten(template: Any, leaves: Dict[Tuple, np.ndarray], path: Tuple = ()) -> Any:
    if template is None:
        return None
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


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def _template(tree: Any) -> Any:
    """The tree with every leaf 0 and dict keys sorted: what
    ``json.dumps(jax.tree_util.tree_map(lambda _: 0, tree))`` gives."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _template(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_template(v) for v in tree]
    return 0


def _treedef(tree: Any) -> str:
    """A structural fingerprint in the form of JAX's ``str(treedef)``."""
    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _host(x) -> Tuple[np.ndarray, str]:
    """A leaf as (a numpy array of its own, its dtype's name): a tensor is
    copied off the card or, on the CPU, out of its storage, so the caller
    may update it in place while a background write runs. numpy has no
    bfloat16: such a leaf is written as its 2-byte patterns, as the
    reference's ``np.save`` of a bfloat16 array writes it, and named
    "bfloat16" in the manifest."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        return a, str(a.dtype)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        return x.cpu().view(torch.int16).numpy().copy().view("V2"), "bfloat16"
    a = x.cpu().numpy()
    return (a.copy() if x.device.type == "cpu" else a), str(a.dtype)


class CheckpointManager:
    """The reference's ``CheckpointManager`` over trees of tensors (or
    numpy arrays, or ints): ``save(step, tree, meta, blocking)`` writes
    ``.tmp-step_<N>`` then renames it to ``step_<N>`` (POSIX-atomic);
    ``blocking=False`` copies the leaves to host memory on the caller's
    thread and writes on a background thread; the newest ``keep`` steps
    stay, older ones are removed after each write."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None,
             blocking: bool = True) -> None:
        self.wait()
        pairs = [_host(x) for x in tree_leaves(tree)]
        host = [a for a, _ in pairs]
        paths = [f"a_{i}" for i in range(len(host))]
        manifest = {
            "step": int(step),
            "treedef": _treedef(tree),
            "tree_template": json.dumps(_template(tree)),
            "leaves": [{"file": p, "dtype": dt, "shape": list(a.shape)}
                       for p, (a, dt) in zip(paths, pairs)],
            "meta": meta or {},
        }

        def write():
            tmp = os.path.join(self.dir, f".tmp-step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for p, a in zip(paths, host):
                np.save(os.path.join(tmp, p + ".npy"), a)
            codec = _codec()
            if codec is None:
                blob = json.dumps(manifest).encode()
            else:
                msgpack, zstandard = codec
                blob = zstandard.ZstdCompressor().compress(msgpack.packb(manifest))
            with open(os.path.join(tmp, "manifest.bin"), "wb") as f:
                f.write(blob)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Block until a background write has finished."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def all_steps(self) -> List[int]:
        return all_steps(self.dir)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: Optional[int] = None) -> Dict:
        """The manifest of ``step`` (newest by default), loading no arrays."""
        self.wait()
        return read_manifest(self.dir, step)

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, Dict]:
        """The saved leaves in the structure of ``template`` (newest step by
        default), plus ``meta`` (with ``step``). Each leaf is a tensor: on
        the template leaf's device where that is a tensor, else on the
        CPU."""
        self.wait()
        step, d = _step_dir(self.dir, step)
        entries = read_manifest(self.dir, step)["leaves"]
        slots = tree_leaves(template)
        if len(slots) != len(entries):
            raise ValueError(f"checkpoint has {len(entries)} leaves, template {len(slots)}")
        out = []
        for slot, e in zip(slots, entries):
            a = np.load(os.path.join(d, e["file"] + ".npy"))
            if e["dtype"] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.asarray(a, order="C"))
            out.append(t.to(slot.device) if isinstance(slot, torch.Tensor) else t)
        meta = read_manifest(self.dir, step).get("meta", {})
        return tree_unflatten(template, out), dict(meta, step=step)
