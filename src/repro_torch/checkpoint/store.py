"""Checkpoint store on the tensor wire protocol (port of
``repro/checkpoint/store.py``), byte-compatible with the reference.

Layout::

    <dir>/step_<N>/
        manifest.json        step, format, bytes, time, leaf index
                             (path -> shape, dtype), extra (data cursor)
        shard_0.bin          one wire-codec pytree frame of {path: leaf}

Leaf paths join dict keys and list indices with "/" as the reference does
("params/blocks/0/ln1/scale"), so a checkpoint of a tree written by either
package restores in the other onto the same tree.  The reference stacks
its blocks into (L, ...) leaves and the port keeps one dict per layer:
those are two trees, and :func:`repro_torch.convert.params_from_jax`
converts between them.

Async: ``save_async`` copies every leaf to host memory before it returns
and writes on a background thread, so training continues at once.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.convert import tree_map
from repro_torch.wire import codec


def _named(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts and lists of tensors, in leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def save(ckpt_dir: Path, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    out = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)
    flat = dict(_named(tree))
    with open(tmp / "shard_0.bin", "wb") as f:
        n = codec.encode_pytree(flat, f)
    manifest = {
        "step": step,
        "format": "repro-wire-v1",
        "bytes": n,
        "time": time.time(),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype).removeprefix("torch.")}
                   for k, v in flat.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)                                   # atomic publish
    _gc(ckpt_dir, keep)
    return out


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: Path) -> Optional[int]:
    steps = sorted(p.name for p in Path(ckpt_dir).glob("step_*") if p.is_dir())
    # repro-lint: allow[R004] parses a checkpoint directory name (a host string), not a tensor
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: Path, step: Optional[int] = None,
            like: Any = None) -> Tuple[Any, dict]:
    """Returns (tree, manifest extra).  Without ``like``, the tree is the
    flat {path: CPU tensor} dict; with it, a tree of ``like``'s structure
    whose leaves take the dtype and device of ``like``'s leaves."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    src = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    with open(src / "shard_0.bin", "rb") as f:
        flat = codec.decode_pytree(f)
    extra = manifest.get("extra", {})
    if like is None:
        return flat, extra
    return _like(like, flat, ""), extra


def _like(tree: Any, flat: Dict[str, torch.Tensor], prefix: str) -> Any:
    """``tree``'s structure over the checkpoint's leaves at the same paths."""
    if isinstance(tree, dict):
        return {k: _like(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree))
    return flat[prefix[:-1]].to(device=tree.device, dtype=tree.dtype)


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, persist on a daemon thread."""

    def __init__(self, ckpt_dir: Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None
        self.error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error:
            raise self.error

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        self.wait()                                   # one in flight
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save(self.dir, step, host_tree, extra, self.keep)
                self.last_saved = step
            except BaseException as e:  # noqa: BLE001  re-raised by wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
