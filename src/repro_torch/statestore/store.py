"""AsymStore: the rNVM protocol over tensors.

The same protocol and on-blade bytes as ``repro.statestore.store``:

  * data area          -> named tensor objects, keyed (version, tensor-name)
  * memory logs + tx   -> a version commit: shard objects written first,
                          then a checksummed MANIFEST, then the atomic root
                          swap — all-or-nothing by construction
  * operation log      -> step log: small records appended every step
  * batching           -> delta commits: top-k-compressed parameter deltas
                          against a base version
  * multi-version+CAS  -> every commit is a new immutable version id; the
                          ROOT pointer names the latest durable version;
                          readers pin any committed version (SWMR)

Tensors are ``.npy`` objects.  bfloat16 is stored as its uint16 bits with
manifest dtype ``"bfloat16"``, as the JAX package stores it; the port reads
and writes those bits with torch, so it needs no ``ml_dtypes``.  Commits
take torch tensors or numpy arrays; reads return CPU torch tensors.  A
commit may bring each object's checksum, computed on the card over the
tensor's bytes; the store folds the ``.npy`` header into it
(``blade.fletcher32_join``) and the blade writes it as it is.
"""

from __future__ import annotations

import io
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..tree import dtype_name, from_numpy, to_numpy
from .blade import Blade, fletcher32_join


def _tensor_key(version: int, name: str, shard: int) -> str:
    return f"v{version:010d}/{name}/s{shard:05d}.npy"


def _manifest_key(version: int) -> str:
    return f"v{version:010d}/MANIFEST.json"


def _npy_bytes(x: Any) -> bytes:
    buf = io.BytesIO()
    np.save(buf, to_numpy(x), allow_pickle=False)
    return buf.getvalue()


def _delta_payload(d: Dict[str, Any]) -> np.ndarray:
    """The delta object's array: vals then idx, both as float32 words, as the
    JAX store writes it."""
    return np.concatenate([to_numpy(d["vals"]).reshape(-1).view(np.float32),
                           to_numpy(d["idx"]).reshape(-1).view(np.float32)])


def _npy_load(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def _cast(t: torch.Tensor, dtype: str) -> torch.Tensor:
    return t.to(getattr(torch, dtype))


class AsymStore:
    """Single-writer, multi-reader versioned tensor store on a blade."""

    def __init__(self, blade: Blade):
        self.blade = blade

    # ------------------------------------------------------------- versions
    def latest_version(self) -> int:
        return self.blade.get_root()

    def committed_versions(self) -> List[int]:
        out = []
        for name in self.blade.list():
            if name.endswith("MANIFEST.json"):
                out.append(int(name.split("/")[0][1:]))
        return sorted(out)

    def manifest(self, version: int) -> Dict[str, Any]:
        return json.loads(self.blade.get(_manifest_key(version)).decode())

    # --------------------------------------------------------------- commit
    def commit_version(
        self,
        version: int,
        tensors: Dict[str, List[Any]],
        meta: Optional[Dict[str, Any]] = None,
        base_version: Optional[int] = None,
        deltas: Optional[Dict[str, Any]] = None,
        checksums: Optional[Dict[str, List[int]]] = None,
    ) -> None:
        """All-or-nothing commit.

        `tensors`: name -> list of full shards.  `deltas`: name -> a top-k
        delta against `base_version` ({"vals" [nb, k] fp32, "idx" [nb, k]
        int32, "n", "block", "dtype"}), one object each.  `checksums`: name ->
        the Fletcher-32 of each object's body (a shard's bytes; a delta's
        vals-then-idx words), when the caller computed them; the blade
        computes the rest.  Ordering: shard objects first, MANIFEST second,
        ROOT swap last — a crash at any point leaves either the old version
        (no manifest / no root) or the complete new one.
        """
        checksums = checksums or {}

        def put(name: str, i: int, arr: Any) -> None:
            data = _npy_bytes(arr)
            csum = None
            if name in checksums:
                n_body = to_numpy(arr).nbytes
                csum = fletcher32_join(data[:len(data) - n_body], n_body, checksums[name][i])
            self.blade.put(_tensor_key(version, name, i), data, csum)

        entries: Dict[str, Any] = {}
        for name, shards in (tensors or {}).items():
            for i, arr in enumerate(shards):
                put(name, i, arr)
            entries[name] = {
                "kind": "full",
                "n_shards": len(shards),
                "dtype": dtype_name(shards[0]),
                "shard_shape": list(shards[0].shape),
            }
        for name, d in (deltas or {}).items():
            put(name, 0, _delta_payload(d))
            entries[name] = {
                "kind": "delta",
                "base": base_version,
                "n": int(d["n"]),
                "k": int(d["vals"].shape[1]),
                "nb": int(d["vals"].shape[0]),
                "block": int(d["block"]),
                "dtype": str(d["dtype"]),
            }
        manifest = {
            "version": version,
            "base": base_version,
            "time": time.time(),
            "meta": meta or {},
            "tensors": entries,
        }
        self.blade.put(_manifest_key(version), json.dumps(manifest).encode())
        self.blade.set_root(version)  # the atomic root swap

    # ---------------------------------------------------------------- reads
    def read_tensor(self, version: int, name: str) -> List[torch.Tensor]:
        """The shards of `name` at `version` as CPU tensors; a delta entry is
        applied to its base, in float32, and cast back as the JAX store does."""
        man = self.manifest(version)
        ent = man["tensors"][name]
        if ent["kind"] == "full":
            return [
                from_numpy(_npy_load(self.blade.get(_tensor_key(version, name, i))), ent["dtype"])
                for i in range(ent["n_shards"])
            ]
        base = self.read_tensor(ent["base"], name)
        flat = np.concatenate([s.reshape(-1).float().numpy() for s in base])
        raw = _npy_load(self.blade.get(_tensor_key(version, name, 0)))
        nbk = ent["nb"] * ent["k"]
        vals = raw[:nbk].reshape(ent["nb"], ent["k"])
        idx = raw[nbk:].view(np.int32).reshape(ent["nb"], ent["k"])
        # all blocks at once: a block's indices are distinct and blocks do not
        # overlap, so this is the JAX store's per-block loop
        sel = idx + (np.arange(ent["nb"], dtype=np.int64) * ent["block"])[:, None]
        ok = sel < ent["n"]
        flat[sel[ok]] += vals[ok]
        out = []
        off = 0
        for s in base:
            part = torch.from_numpy(flat[off: off + s.numel()].copy()).reshape(s.shape)
            out.append(_cast(part, ent["dtype"]))
            off += s.numel()
        return out

    # ------------------------------------------------------------- step log
    def append_step_log(self, payload: Dict[str, Any]) -> int:
        return self.blade.append(json.dumps(payload).encode())

    def pending_step_logs(self, after_version: int) -> List[Dict[str, Any]]:
        """Step logs recorded after the last committed version — the replay
        set for exact resume (paper §7.5 front-end recovery)."""
        out = []
        for _, payload in self.blade.scan_log():
            rec = json.loads(payload.decode())
            if rec.get("step", -1) > after_version:
                out.append(rec)
        return out

    def gc(self, keep: int = 2) -> None:
        """Drop old versions, never the root and never a delta-chain base of
        a retained version."""
        versions = self.committed_versions()
        keep_set = set(versions[-keep:]) | {self.latest_version()}
        frontier = list(keep_set)
        while frontier:
            v = frontier.pop()
            if v == 0:
                continue
            man = self.manifest(v)
            for ent in man["tensors"].values():
                if ent["kind"] == "delta" and ent["base"] not in keep_set:
                    keep_set.add(ent["base"])
                    frontier.append(ent["base"])
        for v in versions:
            if v in keep_set:
                continue
            for name in self.blade.list(f"v{v:010d}/"):
                self.blade.delete(name)
