"""Live interactive viewer (port of ``gym_puzzles_tpu/render/window.py``):
the rebuild of ``env.render(mode='human')``.

The reference opens a pyglet/OpenGL window through the long-removed
``gym.envs.classic_control.rendering`` module (multi_robot_puzzle_00.py:
528-534, robot.py:3).  GPU hosts are often headless, so the viewer is
display-adaptive with no hard GUI dependency:

* with a reachable display (``$DISPLAY``/``$WAYLAND_DISPLAY`` set and a
  GUI matplotlib backend importable), frames show in an interactive
  matplotlib window updated in place — the pyglet-viewer equivalent;
* otherwise frames draw into the terminal as ANSI truecolor half-blocks
  (the teleop renderer), so ``render(mode='human')`` remains *live* over
  ssh instead of silently returning.

Both paths consume the host rasterizer's rgb_array (render/raster.py).
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _display_available() -> bool:
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


class LiveViewer:
    """Show successive frames in place; picks the best available sink."""

    def __init__(self, cols: int = 100, sink: str | None = None):
        self.cols = cols
        self._fig = None
        self._im = None
        if sink is None:
            sink = "matplotlib" if _display_available() else "ansi"
        if sink == "matplotlib":
            try:
                import matplotlib

                if not _display_available():
                    raise RuntimeError("no display")
                import matplotlib.pyplot as plt  # noqa: F401
            except Exception:
                sink = "ansi"
        self.sink = sink
        self._first = True

    def show(self, frame: np.ndarray) -> None:
        if self.sink == "matplotlib":
            import matplotlib.pyplot as plt

            if self._fig is None:
                plt.ion()
                self._fig, ax = plt.subplots(
                    figsize=(frame.shape[1] / 80, frame.shape[0] / 80))
                ax.set_axis_off()
                self._im = ax.imshow(frame)
            else:
                self._im.set_data(frame)
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()
            return
        from gym_puzzles_tpu_torch.teleop import frame_to_ansi

        prefix = "\x1b[2J\x1b[H" if self._first else "\x1b[H"
        self._first = False
        sys.stdout.write(prefix + frame_to_ansi(frame, self.cols) + "\n")
        sys.stdout.flush()

    def close(self) -> None:
        if self._fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self._fig)
            self._fig = None
