"""Interactive command sources for evaluation (port of
``ti5_isaacgym_tpu/utils/teleop.py``, a copy; reference
``scripts/play.py:44-62``: a pygame joystick thread mutating the command
globals; ``envs/base/base_task.py:89-156``: viewer keyboard events).

Two sources, both feeding a thread-safe ``(vx, vy, wyaw)`` triple that the
play loop writes into ``state.commands`` every step:

* :class:`JoystickTeleop` — pygame joystick polled at 10 Hz on a daemon
  thread with the reference's axis mapping (``-axis1, -axis0, -axis3``);
* :class:`KeyboardTeleop` — raw-terminal (termios cbreak) key reader:
  ``w/s`` = vx +-, ``a/d`` = vy +-, ``q/e`` = yaw +-, space = stop,
  ``x`` = quit.

Both degrade on headless hosts (no joystick or no pygame, no tty): ``ok``
is False, :func:`make_teleop` returns None and the play loop follows the
command schedule.  ``pygame`` is imported only when a joystick is asked for.
"""
from __future__ import annotations

import sys
import threading
from typing import Tuple


class _TeleopBase:
    def __init__(self):
        self._lock = threading.Lock()
        self._cmd = [0.0, 0.0, 0.0]
        self._exit = False
        self.ok = False

    def get(self) -> Tuple[float, float, float]:
        with self._lock:
            return tuple(self._cmd)

    def _set(self, vx, vy, wz):
        with self._lock:
            self._cmd = [float(vx), float(vy), float(wz)]

    @property
    def exited(self) -> bool:
        return self._exit

    def stop(self):
        self._exit = True


class JoystickTeleop(_TeleopBase):
    """Reference mapping (play.py:51-55): vx = -axis1, vy = -axis0,
    wyaw = -axis3, each scaled by ``scale``."""

    def __init__(self, scale: float = 1.0, poll_ms: int = 100):
        super().__init__()
        self.scale = scale
        self.poll_ms = poll_ms
        try:
            import pygame

            pygame.init()
            pygame.joystick.init()
            if pygame.joystick.get_count() == 0:
                raise RuntimeError("no joystick")
            self._js = pygame.joystick.Joystick(0)
            self._js.init()
            self._pygame = pygame
            self.ok = True
        except Exception as e:  # headless host / no controller
            print(f"[teleop] joystick unavailable: {e}")
            return
        t = threading.Thread(target=self._loop, daemon=True)
        t.start()

    def _loop(self):
        pg = self._pygame
        while not self._exit:
            pg.event.get()
            self._set(-self._js.get_axis(1) * self.scale,
                      -self._js.get_axis(0) * self.scale,
                      -self._js.get_axis(3) * self.scale)
            pg.time.delay(self.poll_ms)


class KeyboardTeleop(_TeleopBase):
    """WASD/QE increments on a cbreak tty; the viewer-keyboard analogue of
    the reference's ``subscribe_viewer_keyboard_event`` path."""

    STEP = 0.1

    def __init__(self, stdin=None):
        super().__init__()
        self._stdin = stdin if stdin is not None else sys.stdin
        try:
            import termios  # noqa: F401 — probe availability

            if not self._stdin.isatty():
                raise RuntimeError("stdin is not a tty")
            self.ok = True
        except Exception as e:
            print(f"[teleop] keyboard unavailable: {e}")
            return
        t = threading.Thread(target=self._loop, daemon=True)
        t.start()
        print("[teleop] keys: w/s=vx a/d=vy q/e=yaw space=stop x=quit")

    def apply_key(self, ch: str):
        """Apply one keypress to the command state (exposed for tests)."""
        vx, vy, wz = self.get()
        s = self.STEP
        if ch == "w":
            vx += s
        elif ch == "s":
            vx -= s
        elif ch == "a":
            vy += s
        elif ch == "d":
            vy -= s
        elif ch == "q":
            wz += s
        elif ch == "e":
            wz -= s
        elif ch == " ":
            vx = vy = wz = 0.0
        elif ch == "x":
            self._exit = True
        self._set(vx, vy, wz)

    def _loop(self):
        import termios
        import tty

        fd = self._stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while not self._exit:
                ch = self._stdin.read(1)
                self.apply_key(ch)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)


def make_teleop(kind: str):
    """'joystick' | 'keyboard' | 'auto' -> a teleop source or None."""
    if kind in ("joystick", "auto"):
        js = JoystickTeleop()
        if js.ok:
            return js
        if kind == "joystick":
            return None
    if kind in ("keyboard", "auto"):
        kb = KeyboardTeleop()
        if kb.ok:
            return kb
    return None
