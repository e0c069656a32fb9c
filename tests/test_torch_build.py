"""The kernels' build (``repro_torch.kernels._build``) is safe when several
processes build the same sources at once, as ``pytest -n 4 -m cuda`` does on
a fresh checkout, and leaves no object behind.

No compiler is needed: a fake ``nvcc`` put first on ``PATH`` logs its call,
waits until both build processes are compiling (so the two builds really
overlap), sleeps briefly and writes its ``-o`` file; a link writes the
names of the objects it was given.  Two processes then run ``_build._compile`` on the
package's real sources into one temporary ``BUILD_DIR``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

from repro_torch.kernels import _build

FAKE_NVCC = textwrap.dedent('''\
    #!{python}
    import json, os, sys, time
    log = {log!r}
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    link = "-shared" in args
    objs = [a for a in args if a.endswith(".o")] if link else []
    src = None if link else args[args.index("-c") + 1]
    with open(log, "a") as f:
        f.write(json.dumps({{"ppid": os.getppid(), "link": link,
                             "out": out, "objs": objs, "src": src}}) + "\\n")
    if not link:
        # wait (at most 30 s) until both build processes are compiling
        t0 = time.time()
        while time.time() - t0 < 30:
            with open(log) as f:
                rows = [json.loads(x) for x in f]
            if len({{r["ppid"] for r in rows if not r["link"]}}) >= 2:
                break
            time.sleep(0.05)
        if src.endswith(os.environ.get("FAKE_NVCC_FAIL", "-")):
            print("error: fake compile failure")
            sys.exit(1)
    time.sleep(0.2)
    with open(out, "w") as f:
        f.write("\\n".join(objs) if link else "object of " + src)
''')

BUILD_SCRIPT = textwrap.dedent('''\
    import sys
    from pathlib import Path
    from repro_torch.kernels import _build
    _build.BUILD_DIR = Path(sys.argv[1])
    sources = sorted(_build.CSRC.glob("*.cu"))
    try:
        _build._compile(sources, _build.BUILD_DIR / "lib_test.so", "test")
    except RuntimeError as e:
        print("RuntimeError:", e)
        sys.exit(3)
''')


def _run_two_builds(tmp_path, fail=None):
    fake_dir, build_dir = tmp_path / "bin", tmp_path / "build"
    fake_dir.mkdir()
    log = tmp_path / "nvcc.log"
    log.touch()
    nvcc = fake_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    src_dir = Path(_build.__file__).resolve().parents[2]
    env = dict(os.environ, PATH=f"{fake_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(src_dir))
    if fail:
        env["FAKE_NVCC_FAIL"] = fail
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, str(build_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    rows = [json.loads(x) for x in log.read_text().splitlines()]
    return procs, outs, rows, build_dir


def test_two_concurrent_builds_link_their_own_objects(tmp_path):
    procs, outs, rows, build_dir = _run_two_builds(tmp_path)
    assert [p.returncode for p in procs] == [0, 0], outs
    n_src = len(list(_build.CSRC.glob("*.cu")))
    build_pids = {p.pid for p in procs}
    compiled = {}
    for r in rows:
        if not r["link"]:
            compiled.setdefault(r["ppid"], set()).add(r["out"])
    assert set(compiled) == build_pids
    assert all(len(objs) == n_src for objs in compiled.values())
    # each process's objects carry its pid and are its own
    for pid, objs in compiled.items():
        assert all(Path(o).name.endswith(f".{pid}.o") for o in objs)
    assert not set.intersection(*compiled.values())
    links = [r for r in rows if r["link"]]
    assert sorted(r["ppid"] for r in links) == sorted(build_pids)
    for r in links:
        assert set(r["objs"]) == compiled[r["ppid"]]
    # the library is in place, and no object or temporary is left behind
    assert sorted(p.name for p in build_dir.iterdir()) == ["lib_test.so"]


def test_failed_build_leaves_no_objects(tmp_path):
    procs, outs, rows, build_dir = _run_two_builds(
        tmp_path, fail="update_chain.cu")
    assert [p.returncode for p in procs] == [3, 3], outs
    assert all("nvcc failed on update_chain.cu" in o for o in outs)
    assert not any(r["link"] for r in rows)
    assert list(build_dir.iterdir()) == []
