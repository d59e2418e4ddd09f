"""Whether an interactive window can open (the CLI's --show and the
epipolar viewer): cv2 must import and, on Linux, a display must exist.
cv2's Qt backend calls abort() (no catchable Python exception) when no X
display exists, so a failed imshow cannot be recovered in a frame loop:
the conditions are probed up front. cv2 is imported here only, lazily."""

from __future__ import annotations

import os
import sys
from typing import Tuple


def gui_available() -> Tuple[bool, str]:
    """(True, "") when windows can open, else (False, why)."""
    try:
        import cv2  # noqa: F401
    except Exception as exc:
        return False, f"cv2 unavailable ({type(exc).__name__}: {exc})"
    # X/Wayland probing only makes sense on Linux; macOS's Cocoa HighGUI
    # backend needs no display variable
    if sys.platform.startswith("linux") and not (
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        return False, "no DISPLAY (headless environment)"
    return True, ""
