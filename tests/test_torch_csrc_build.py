"""The kernel build's file handling when several ranks build at once
(``spatialthinker_torch/csrc/__init__.py``), with ``nvcc`` replaced by a stub
that writes its outputs slowly: two builds that overlap in time use object
and link files of their own, each renames a whole library into place, and
nothing of either is left behind. No CUDA toolkit is needed."""

import sys
import threading

from spatialthinker_torch import csrc

STUB = """import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
time.sleep(0.3)
if "-shared" in args:
    objs = [a for a in args if a.endswith(".o")]
    data = b"".join(open(o, "rb").read() for o in objs)
else:
    data = ("obj:" + args[-1]).encode()
with open(out, "wb") as f:
    for i in range(0, len(data), 7):
        f.write(data[i : i + 7]); f.flush(); time.sleep(0.001)
"""


def test_two_overlapping_builds_do_not_touch_each_other(tmp_path, monkeypatch):
    stub = tmp_path / "nvcc"
    stub.write_text(f"#!{sys.executable}\n{STUB}")
    stub.chmod(0o755)
    monkeypatch.setattr(csrc, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def one_build():
        try:
            paths.append(csrc.build())
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=one_build) for _ in range(2)]  # one pid for both
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(paths) == 2 and paths[0] == paths[1] == csrc.library_path()
    want = b"".join(f"obj:{csrc.CSRC_DIR / name}".encode() for name in csrc.SOURCES)
    assert paths[0].read_bytes() == want  # one whole link output, not two interleaved
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]
