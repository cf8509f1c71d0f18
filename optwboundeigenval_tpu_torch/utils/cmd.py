"""Subprocess runner with an optional pseudo-terminal, and git helpers
(the port's own copy of ``optwboundeigenval_tpu/utils/cmd.py``, pure
Python; importing the JAX package would import JAX).

The reference's ``cmd.py`` (cmd.py:13-89) exposes ``run_cmd``
(optionally under a pseudo-terminal, so that tools which print progress
only to a tty behave as if interactive) and ``git_pull``/``git_push``;
only commented-out code of the reference driver calls them
(opt.py:2032-2037).  The child is watched with ``select`` on the pty
master and ``Popen.poll`` rather than a SIGCHLD handler, which would be
process-global state inside a library.
"""

from __future__ import annotations

import os
import re
import select
import subprocess
import sys
from subprocess import CalledProcessError

__all__ = ["run_cmd", "git_pull", "git_push"]


def _drain_pty(master: int, proc: subprocess.Popen, silent: bool) -> bytes:
    """Read the pty master until the child exits and the buffer drains."""
    chunks = []
    while True:
        ready, _, _ = select.select([master], [], [], 0.1)
        if ready:
            try:
                data = os.read(master, 4096)
            except OSError:
                # EIO: the slave side closed (child exited) — Linux pty
                # semantics when no client remains.
                break
            if not data:
                break
            data = data.replace(b"\x0f", b"")  # ^O shift-in noise
            if not silent:
                sys.stderr.buffer.write(data)
                sys.stderr.buffer.flush()
            chunks.append(data)
        elif proc.poll() is not None:
            break
    return b"".join(chunks)


def run_cmd(cmd, *, use_pty: bool = False, silent: bool = False,
            cwd=None) -> str:
    """Run ``cmd`` and return its combined stdout+stderr as text.

    Mirrors the reference surface (cmd.py:28-89): ``use_pty`` attaches
    the child to a pseudo-terminal (so it sees ``isatty() == True``),
    ``silent`` suppresses live echo to stderr, carriage-return
    overwrites are collapsed to the final line, and a non-zero exit
    raises ``CalledProcessError`` carrying the captured output.
    """
    if use_pty:
        master, slave = os.openpty()
        try:
            proc = subprocess.Popen(
                cmd, stdin=slave, stdout=slave, stderr=slave, cwd=cwd,
                close_fds=True,
            )
            os.close(slave)
            slave = -1
            raw = _drain_pty(master, proc, silent)
        finally:
            if slave >= 0:
                os.close(slave)
            os.close(master)
        code = proc.wait()
    else:
        proc = subprocess.Popen(
            cmd, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, cwd=cwd,
        )
        raw, _ = proc.communicate()
        raw = raw.replace(b"\x0f", b"")
        if not silent and raw:
            sys.stderr.buffer.write(raw)
            sys.stderr.buffer.flush()
        code = proc.returncode

    out = raw.decode("utf-8", errors="replace").replace("\r\n", "\n")
    # a bare \r rewinds the line: keep only what survives the overwrite
    out = re.sub(r".*\r", "", out)
    if code != 0:
        raise CalledProcessError(code, cmd, out)
    return out


def git_pull(cwd=None) -> bool:
    """``git pull --no-edit``; True iff something new arrived
    (cmd.py:13-15).

    The reference greps for ``up-to-date`` — the pre-2.15 git wording;
    modern git prints "Already up to date." (no hyphens), which would
    make the reference always report updates.  Match both spellings.
    """
    output = run_cmd(["git", "pull", "--no-edit"], cwd=cwd)
    return "up-to-date" not in output and "up to date" not in output


def git_push(cwd=None) -> None:
    """``git push``, rebasing-and-retrying on non-fast-forward
    rejections (cmd.py:17-26)."""
    while True:
        try:
            run_cmd(["git", "push"], cwd=cwd)
            return
        except CalledProcessError as e:
            out = e.output or ""
            if "non-fast-forward" in out or "fetch first" in out:
                run_cmd(["git", "pull", "--rebase"], cwd=cwd)
            else:
                raise
