"""Interactive keyboard teleop (port of ``gym_puzzles_tpu/teleop.py``), the
rebuild of the reference's ``__main__`` blocks (multi_robot_puzzle_00.py:
617-654, 02.py:719-758, core.py:466-507 -- pyglet arrow-key control of
agent 0).

GL-free: renders the host rasterizer's frame as ANSI truecolor half-blocks
straight into the terminal, so it works over ssh.  The env is
:class:`~gym_puzzles_tpu_torch.api.gym_compat.GymPuzzleEnv` on ``--device``
(default ``cuda``: one launch of the fused tick kernel per step).

    python -m gym_puzzles_tpu_torch.teleop --env MultiRobotPuzzle-v0

Keys: arrows / WASD steer agent 0, q/e rotate, space stop, ESC quit.
"""

from __future__ import annotations

import argparse
import select
import sys
import termios
import time
import tty

import numpy as np


def frame_to_ansi(img: np.ndarray, cols: int = 100) -> str:
    """Downsample an (H, W, 3) frame to terminal half-block art."""
    h, w, _ = img.shape
    step = max(1, w // cols)
    small = img[:: step * 2, ::step]  # two rows per char cell
    lower = img[step :: step * 2, ::step][: small.shape[0]]
    lines = []
    for y in range(min(len(small), len(lower))):
        row = []
        for x in range(small.shape[1]):
            r1, g1, b1 = small[y, x]
            r2, g2, b2 = lower[y, x]
            row.append(f"\x1b[38;2;{r1};{g1};{b1}m\x1b[48;2;{r2};{g2};{b2}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="MultiRobotPuzzle-v0")
    parser.add_argument("--fps", type=float, default=20.0)
    parser.add_argument("--cols", type=int, default=110)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs the plain engine)")
    args = parser.parse_args(argv)

    from gym_puzzles_tpu_torch.api.gym_compat import GymPuzzleEnv

    env = GymPuzzleEnv(args.env, device=args.device)
    obs = env.reset()
    act_dim = env.spec_cfg.act_dim
    per_agent = 2 if env.spec_cfg.variant == "v2" else 3
    a = np.zeros(act_dim, np.float32)
    reward_sum = 0.0

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    try:
        print("\x1b[2J", end="")
        while True:
            while select.select([sys.stdin], [], [], 0)[0]:
                ch = sys.stdin.read(1)
                if ch == "\x1b":
                    nxt = sys.stdin.read(1) if select.select([sys.stdin], [], [], 0.01)[0] else ""
                    if nxt == "[":
                        code = sys.stdin.read(1)
                        if code == "A":
                            ch = "w"
                        elif code == "B":
                            ch = "s"
                        elif code == "C":
                            ch = "d"
                        elif code == "D":
                            ch = "a"
                    else:
                        return
                if ch == "q":
                    a[min(2, per_agent - 1)] = min(a[min(2, per_agent - 1)] + 0.2, 1)
                elif ch == "e":
                    a[min(2, per_agent - 1)] = max(a[min(2, per_agent - 1)] - 0.2, -1)
                elif ch == "w":
                    a[1] = min(a[1] + 0.1, 1.0)
                elif ch == "s":
                    a[1] = max(a[1] - 0.1, -1.0)
                elif ch == "d":
                    a[0] = min(a[0] + 0.1, 1.0)
                elif ch == "a":
                    a[0] = max(a[0] - 0.1, -1.0)
                elif ch == " ":
                    a[:per_agent] = 0.0
                elif ch in ("\x03", "Q"):
                    return

            obs, reward, done, info = env.step(a)
            reward_sum += reward
            frame = env.render(mode="rgb_array")
            print("\x1b[H" + frame_to_ansi(frame, args.cols))
            print(f"\x1b[0m action={np.round(a[:per_agent], 2)} r={reward:+8.3f} "
                  f"R={reward_sum:+10.2f} done={done}   (ESC quits)")
            if done:
                print("episode done; resetting")
                obs = env.reset()
                reward_sum = 0.0
            time.sleep(1.0 / args.fps)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        print("\x1b[0m")


if __name__ == "__main__":
    main()
