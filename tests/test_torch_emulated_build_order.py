"""The emulated build writes every rewritten source before it starts a
compiler (test_torch_emulated_runtime.emulated_library): a .cu file
includes headers that sort after it, and a compiler started early reads a
header that is not there yet."""
import subprocess
import time
from pathlib import Path

import pytest

import test_torch_emulated_runtime as emu


class FakeProc:
    returncode = 0

    def communicate(self, timeout=None):
        return "", ""


@pytest.mark.parametrize("names", [None, ["ablate.cu"]], ids=["all", "ablate"])
def test_no_compiler_starts_before_the_last_file_is_written(names, tmp_path, monkeypatch):
    """With each write slowed, every compiler starts after the last write,
    and each one it starts compiles a file already written."""
    events = []
    write_text = Path.write_text

    def slow_write(self, text, *args, **kwargs):
        time.sleep(0.01)
        out = write_text(self, text, *args, **kwargs)
        events.append(("write", self.name))
        return out

    def popen(cmd, **kwargs):
        events.append(("compile", Path(cmd[-1]).name))
        return FakeProc()

    monkeypatch.setattr(Path, "write_text", slow_write)
    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: FakeProc())
    monkeypatch.setattr(emu.shutil, "which", lambda name: "/usr/bin/" + name)
    emu.emulated_library(tmp_path, names)
    kinds = [kind for kind, _ in events]
    compiled = [name for kind, name in events if kind == "compile"]
    written = {name for kind, name in events if kind == "write"}
    assert compiled and kinds == sorted(kinds, key=["write", "compile"].index)
    assert written == {"cuda_runtime.h"} | {p.name for p in emu.build.CSRC_DIR.iterdir()}
    assert set(compiled) == ({"ablate.cu"} if names else
                             {p.name for p in emu.build.CSRC_DIR.glob("*.cu")})
