"""Start W ranks of a module with ``torch.distributed.run`` (``torchrun``)
as a child process with a time limit.

``torchrun --standalone`` picks a free port on the host, so that several
groups can start side by side. The child runs in a session of its own:
at the time limit the whole session (``torchrun`` and every rank) is
killed, so that a rank that hangs in a collective leaves no process
behind. ``threads`` sets each rank's OpenMP and torch intra-op threads
(``OMP_NUM_THREADS``). The package's parent directory goes first on the
child's ``PYTHONPATH``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Mapping, NamedTuple, Optional, Sequence


#: the directory that holds the package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Launched(NamedTuple):
    returncode: int
    stdout: str
    stderr: str


def torchrun_command(nproc: int, module: str, args: Sequence[str] = ()) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), "-m", module, *args]


def run_child(cmd: Sequence[str], timeout: float, threads: Optional[int] = None,
              env: Optional[Mapping[str, str]] = None, cwd: Optional[str] = None) -> Launched:
    """Run ``cmd`` in a session of its own; at ``timeout`` seconds kill the
    session and raise ``TimeoutError`` with what it printed."""
    child_env = dict(os.environ if env is None else env)
    # the package's parent on the path, from whatever directory
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, child_env.get("PYTHONPATH")) if p)
    if threads is not None:
        child_env["OMP_NUM_THREADS"] = str(threads)
    proc = subprocess.Popen(list(cmd), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=child_env, cwd=cwd, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise TimeoutError(f"{' '.join(cmd)} passed its {timeout} s:\n{out[-4000:]}\n"
                           f"{err[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return Launched(proc.returncode, out, err)


def launch(nproc: int, module: str, args: Sequence[str] = (), timeout: float = 600.0,
           threads: Optional[int] = None, env: Optional[Mapping[str, str]] = None,
           cwd: Optional[str] = None) -> Launched:
    """``torchrun --standalone --nproc_per_node nproc -m module args``."""
    return run_child(torchrun_command(nproc, module, args), timeout, threads, env, cwd)
