"""UDP robot-control socket — `udpSocket` parity (`src/UDP2robot.cpp`).

The fork's "Mobile Gait System" drives a Double telepresence robot from the
tracked pelvis (HIP_C) position: an int command {0..8} is sent over UDP at
`Send_inverval` ms; a client socket receives robot feedback
(`UDP2robot.cpp:40-110`, YAML keys `Examples/ORB_RGBD640x480.yaml:95-109`).

Command semantics carried over exactly (`GenerateForwardControlCmd`,
`UDP2robot.cpp:180-213`; `GenerateRotCmd` `:165-178`):
0 stop | 1 fwd | 2 back | 3 turn+ | 4 turn- | 5 fwd+turn+ | 6 fwd+turn- |
7 back+turn+ | 8 back+turn-. `GenerateBackwardControlCmd` is a stub in the
reference (`:215-219` returns 0) and stays one here.

Port of `orbslam_mapsave_tpu/apps/udp_robot.py`, a copy over the port's
config (host sockets and threads in both packages).
"""

from __future__ import annotations

import math
import socket
import threading
import time

from ..config import UDPConfig


def generate_rot_cmd(hip_c, thres_deg: float) -> int:
    """`GenerateRotCmd` (`UDP2robot.cpp:165-178`)."""
    x, _, z = hip_c
    alpha = math.atan(x / z) * 180.0 / 3.1415 if z != 0 else 0.0
    if alpha > thres_deg:
        return 3
    if alpha < -thres_deg:
        return 4
    return 0


def generate_forward_cmd(hip_c, angle_thres: float, dist_min: float,
                         dist_max: float) -> int:
    """`GenerateForwardControlCmd` (`UDP2robot.cpp:180-213`)."""
    x, _, z = hip_c
    dist = z
    alpha = 0.0 if dist == 0 else math.atan(x / z) * 180.0 / 3.1415
    a = abs(alpha)
    if a < angle_thres and dist_min < dist < dist_max:
        return 0
    if a < angle_thres and dist < dist_min:
        return 2
    if a < angle_thres and dist > dist_max:
        return 1
    if alpha > angle_thres and dist_min < dist < dist_max:
        return 3
    if alpha < -angle_thres and dist_min < dist < dist_max:
        return 4
    if alpha > angle_thres and dist < dist_min:
        return 7
    if alpha > angle_thres and dist > dist_max:
        return 5
    if alpha < -angle_thres and dist < dist_min:
        return 8
    return 0


def generate_backward_cmd(hip_c, angle_thres, dist_min, dist_max) -> int:
    """`GenerateBackwardControlCmd` — reference stub returns 0
    (`UDP2robot.cpp:215-219`)."""
    return 0


class UDPRobot:
    """Server thread sending commands at `send_interval_ms`
    (`udpSocket::RunServer`) + client thread receiving feedback
    (`RunClient`)."""

    def __init__(self, cfg: UDPConfig | None = None):
        self.cfg = cfg or UDPConfig()
        self.hip_c = (0.0, 0.0, 0.0)
        self.close_server = False  # mCloseServer
        self.close_client = False
        self.control_command: list[int] = []  # mControlCommand
        self._threads: list[threading.Thread] = []

    def update_hip(self, hip_c) -> None:
        self.hip_c = tuple(float(v) for v in hip_c)

    def current_command(self) -> int:
        c = self.cfg
        if c.robot_mode == 0:
            return generate_forward_cmd(self.hip_c, c.angle_thres_deg,
                                        c.dist_thres_min_m, c.dist_thres_max_m)
        if c.robot_mode == 1:
            return generate_backward_cmd(self.hip_c, c.angle_thres_deg,
                                         c.dist_thres_min_m, c.dist_thres_max_m)
        return generate_rot_cmd(self.hip_c, c.angle_thres_deg)

    def run_server(self) -> None:
        """Send loop (`udpSocket::RunServer`, `UDP2robot.cpp:40-72`)."""
        c = self.cfg
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        addr = (c.ip_client, c.port_out)
        try:
            while not self.close_server:
                cmd = self.current_command()
                sock.sendto(str(cmd).encode(), addr)
                time.sleep(c.send_interval_ms / 1e3)
        finally:
            sock.close()

    def run_client(self) -> None:
        """Receive loop (`udpSocket::RunClient`, `UDP2robot.cpp:74-110`)."""
        c = self.cfg
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("0.0.0.0", c.port_in))
        sock.settimeout(c.receiver_interval_ms / 1e3)
        timeout_cnt = 0
        try:
            while not self.close_client and timeout_cnt < c.timeout_max:
                try:
                    data, _ = sock.recvfrom(c.buf_size)
                    self.control_command.append(int(data.decode() or 0))
                    timeout_cnt = 0
                except (socket.timeout, ValueError):
                    timeout_cnt += 1
        finally:
            sock.close()

    def start(self) -> None:
        for fn in (self.run_server, self.run_client):
            th = threading.Thread(target=fn, daemon=True)
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self.close_server = self.close_client = True
        for th in self._threads:
            th.join(timeout=1.0)
