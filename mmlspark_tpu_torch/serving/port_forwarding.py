"""SSH port forwarding for serving behind NAT / VNet.

Reference: io/http/PortForwarding.scala:12 (jsch SSH tunnels keeping serving
endpoints reachable in VNet mode).  Here: a managed `ssh -N -R/-L` subprocess
with keepalive options; command construction is separated from process
launch so it is unit-testable without an SSH server.  A copy of the JAX
package's `serving/port_forwarding.py` for this package.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import List, Optional

__all__ = ["forwarding_command", "PortForwarder"]


def forwarding_command(
    remote_host: str,
    remote_port: int,
    local_port: int,
    user: Optional[str] = None,
    key_file: Optional[str] = None,
    reverse: bool = True,
    ssh_port: int = 22,
) -> List[str]:
    """Build the ssh tunnel argv.

    reverse=True (-R): expose the local serving port on the remote bastion
    (the VNet mode of the reference); reverse=False (-L): pull a remote
    service to localhost.
    """
    target = f"{user}@{remote_host}" if user else remote_host
    spec = (
        f"{remote_port}:127.0.0.1:{local_port}" if reverse
        else f"{local_port}:127.0.0.1:{remote_port}"
    )
    cmd = [
        "ssh", "-N", "-p", str(ssh_port),
        "-o", "StrictHostKeyChecking=accept-new",
        "-o", "ServerAliveInterval=30",
        "-o", "ExitOnForwardFailure=yes",
        "-R" if reverse else "-L", spec,
    ]
    if key_file:
        cmd += ["-i", key_file]
    cmd.append(target)
    return cmd


class PortForwarder:
    """Managed tunnel subprocess (start/stop/alive)."""

    def __init__(self, *args, **kwargs):
        self.command = forwarding_command(*args, **kwargs)
        self._proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        if self.alive:
            raise RuntimeError("tunnel already running; stop() it first")
        if shutil.which("ssh") is None:
            raise RuntimeError("ssh binary not available for port forwarding")
        self._proc = subprocess.Popen(
            self.command, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
        )

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()  # reap: no zombie
            self._proc = None
