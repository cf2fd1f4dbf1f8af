"""Project file management (counterpart of audiolab_tpu/core/project.py;
reference: util/data_classes.py:10-67).

Per-input project dir ``outputs/process/{name}_{xxhash64[:8]}`` with a
``source/`` copy of the input; processors append outputs per stage and the
chain feeds each stage's outputs to the next.  The digest is xxhash64 where
the host has ``xxhash`` and sha256 otherwise, as in the JAX package, so a
project directory has the same name in both packages.
"""

from __future__ import annotations

import os
import shutil

try:
    import xxhash

    def _hash_file(path: str) -> str:
        h = xxhash.xxh64()
        with open(path, "rb") as f:
            for blk in iter(lambda: f.read(1 << 20), b""):
                h.update(blk)
        return h.hexdigest()[:8]

except ImportError:  # pragma: no cover
    import hashlib

    def _hash_file(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for blk in iter(lambda: f.read(1 << 20), b""):
                h.update(blk)
        return h.hexdigest()[:8]


class ProjectFiles:
    """Content-hashed project directory for one input file."""

    def __init__(self, src_file: str, output_root: str = "outputs/process"):
        self.src_file = os.path.abspath(src_file)
        name = os.path.splitext(os.path.basename(src_file))[0]
        digest = _hash_file(self.src_file)
        self.project_dir = os.path.join(output_root, f"{name}_{digest}")
        src_dir = os.path.join(self.project_dir, "source")
        os.makedirs(src_dir, exist_ok=True)
        local_src = os.path.join(src_dir, os.path.basename(src_file))
        if not os.path.exists(local_src):
            shutil.copy2(self.src_file, local_src)
        self.src_file = local_src

        # walk existing stage subfolders (project reload, data_classes.py:40-47)
        self.file_dict: dict[str, list[str]] = {}
        for entry in sorted(os.listdir(self.project_dir)):
            full = os.path.join(self.project_dir, entry)
            if os.path.isdir(full) and entry != "source":
                self.file_dict[entry] = [
                    os.path.join(full, f) for f in sorted(os.listdir(full))
                ]
        self.last_outputs: list[str] = [self.src_file]

    def stage_dir(self, process: str) -> str:
        d = os.path.join(self.project_dir, process)
        os.makedirs(d, exist_ok=True)
        return d

    def add_output(self, process: str, files: list[str] | str) -> None:
        if isinstance(files, str):
            files = [files]
        self.file_dict.setdefault(process, [])
        self.file_dict[process].extend(files)
        self.last_outputs = list(files)

    def all_outputs(self) -> list[str]:
        out = []
        for files in self.file_dict.values():
            out.extend(files)
        return out
