"""Fault-tolerant checkpointing: a port of
``src/repro/train/checkpoint.py``, in the reference's on-disk format, so
that each package reads the other's checkpoints.

* **atomicity** — write to ``<dir>/.tmp-<step>-p<k>``, fsync files, then a
  single atomic ``rename`` to ``step_<n>``; a crash mid-write can never
  leave a checkpoint that ``latest_step`` would pick up;
* **format** — ``manifest.p<k>.json`` (``{"step", "leaves": {key:
  {"file", "shape", "dtype"}}}``) and one ``.npy`` per leaf, keyed by the
  reference's ``/``-joined paths.  The port's ``blocks`` (a list of one
  dict per repeat) is stacked along a leading axis on save, as the
  reference holds it, and split again on restore; bf16 leaves are saved as
  their ``uint16`` bits under the dtype name ``"bfloat16"`` and read back
  through ``torch.Tensor.view(torch.bfloat16)`` (no ``ml_dtypes``);
* **resume** — ``restore_latest`` walks newest → oldest, skipping
  checkpoints that fail verification (truncated shard, bad manifest);
* **keep-N** — bounded disk; oldest checkpoints garbage-collected after a
  successful save;
* **async** — the device→host copy happens on the caller's thread, the
  write on a background thread, so the train loop overlaps the write with
  the next steps; ``wait()`` re-raises a worker's error.

Restored trees hold CPU tensors (``restore(step, device=...)`` moves
them).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from repro_torch.tree import stack_blocks, unstack_blocks


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict) and node and all(
            k.startswith("__") for k in node
        ):
            return tuple(
                fix(node[f"__{i}"]) for i in range(len(node))
            )
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _to_host(leaf) -> np.ndarray:
    """A leaf as host numpy; bf16 as its ``uint16`` bits, dtype name kept
    apart."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, async_write: bool = True,
                 process_index: int | None = None):
        self.dir = directory
        self.keep_n = keep_n
        self.async_write = async_write
        # one process per card here; multi-process training is ROADMAP A16.3
        self.process_index = process_index if process_index is not None else 0
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._worker = None
        self._err = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree):
        """Snapshot to host, then serialize (async by default)."""
        flat = _flatten(stack_blocks(tree))
        host = {k: (_to_host(v), _dtype_name(v)) for k, v in flat.items()}
        if self.async_write:
            self._ensure_worker()
            self._q.put((step, host))
        else:
            self._write(step, host)

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write(*item)
            except Exception as e:  # surfaced on next wait()
                self._err = e

    def wait(self):
        """Block until queued writes finish (used before shutdown/tests)."""
        if self._worker is not None and self._worker.is_alive():
            self._q.put(None)
            self._worker.join()
            self._worker = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _write(self, step: int, host: dict):
        tmp = os.path.join(self.dir, f".tmp-{step}-p{self.process_index}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for key, (arr, dtype_name) in host.items():
            fname = f"{key.replace('/', '.')}.p{self.process_index}.npy"
            path = os.path.join(tmp, fname)
            with open(path, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest[key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype_name,
            }
        with open(os.path.join(tmp, f"manifest.p{self.process_index}.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, device=None):
        """The tree saved at ``step``, its leaves tensors (on the CPU unless
        ``device`` names another), ``blocks`` as a list of per-repeat
        dicts."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        mpath = os.path.join(d, f"manifest.p{self.process_index}.json")
        with open(mpath) as f:
            manifest = json.load(f)
        flat = {}
        for key, info in manifest["leaves"].items():
            arr = np.load(os.path.join(d, info["file"]))
            if list(arr.shape) != info["shape"]:
                raise IOError(f"shard {key} corrupt: {arr.shape} != {info['shape']}")
            if info["dtype"] == "bfloat16":
                if arr.dtype != np.uint16:
                    raise IOError(f"shard {key}: bfloat16 saved as {arr.dtype}")
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            elif str(arr.dtype) != info["dtype"]:
                raise IOError(f"shard {key}: {arr.dtype} != {info['dtype']}")
            else:
                t = torch.from_numpy(arr)
            flat[key] = t if device is None else t.to(device)
        return unstack_blocks(_unflatten(flat))

    def restore_latest(self, device=None):
        """Newest verifiable checkpoint (skips corrupt ones) or None."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, device)
            except Exception:
                continue
        return None, None
