"""Filesystem abstraction: LocalFS + HDFSClient (counterpart of
``paddle_tpu/distributed/fs.py``; reference python/paddle/distributed/
fleet/utils/fs.py). The parameter server's snapshot tier writes
through it.

LocalFS is fully functional; HDFSClient shells out to `hadoop fs` when a
hadoop binary is configured and raises a clear error otherwise (an
environment without HDFS still lets snapshot code take an `fs`
parameter portably).
"""
from __future__ import annotations

import os
import shutil
import subprocess

__all__ = ["FS", "LocalFS", "HDFSClient", "FSFileExistsError",
           "FSFileNotExistsError"]


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FS:
    def ls_dir(self, path):
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def mv(self, src, dst, overwrite=False):
        raise NotImplementedError

    def touch(self, path, exist_ok=True):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError


class LocalFS(FS):
    """Local filesystem backend (reference fs.py LocalFS)."""

    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for e in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, e))
             else files).append(e)
        return dirs, files

    def is_file(self, path):
        return os.path.isfile(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.unlink(path)

    def mv(self, src, dst, overwrite=False):
        if not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if self.is_exist(dst):
            if not overwrite:
                raise FSFileExistsError(dst)
            self.delete(dst)
        shutil.move(src, dst)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path) and not exist_ok:
            raise FSFileExistsError(path)
        open(path, "a").close()

    def upload(self, local_path, fs_path):
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path)
        else:
            shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        self.upload(fs_path, local_path)


class HDFSClient(FS):
    """`hadoop fs` subprocess wrapper (reference fs.py HDFSClient).
    Needs a hadoop binary: pass hadoop_home or have `hadoop` on PATH."""

    def __init__(self, hadoop_home=None, configs=None, time_out=300,
                 sleep_inter=1000):
        self._hadoop = os.path.join(hadoop_home, "bin", "hadoop") \
            if hadoop_home else shutil.which("hadoop")
        self._cfg = []
        for k, v in (configs or {}).items():
            self._cfg += ["-D", f"{k}={v}"]
        self._timeout = time_out

    def _run(self, *args):
        if self._hadoop is None:
            raise RuntimeError(
                "HDFSClient needs a hadoop binary (hadoop_home= or "
                "`hadoop` on PATH); this environment has none — use "
                "LocalFS")
        res = subprocess.run(
            [self._hadoop, "fs"] + self._cfg + list(args),
            capture_output=True, text=True, timeout=self._timeout)
        return res.returncode, res.stdout

    def ls_dir(self, path):
        rc, out = self._run("-ls", path)
        if rc != 0:
            return [], []
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, path):
        return self._run("-test", "-e", path)[0] == 0

    def is_file(self, path):
        return self._run("-test", "-f", path)[0] == 0

    def is_dir(self, path):
        return self._run("-test", "-d", path)[0] == 0

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", "-f", path)

    def mv(self, src, dst, overwrite=False):
        if overwrite and self.is_exist(dst):
            self.delete(dst)
        self._run("-mv", src, dst)

    def touch(self, path, exist_ok=True):
        if not exist_ok and self.is_exist(path):
            raise FSFileExistsError(path)
        self._run("-touchz", path)

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)
