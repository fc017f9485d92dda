"""Draw predictions onto an image, in numpy (the card's machine has no OpenCV).

Counterpart of ``rsprompter_tpu/apis/inferencer.py`` ``draw_predictions``
(:353), the reference's ``DetLocalVisualizer`` analogue. For each detection
in order: its box outline in the class's palette colour, as
``cv2.rectangle(..., thickness=2)`` draws it (the pixels within one of an
edge, the four outer corner pixels left out), then the label
``name:score``, then the mask blended as ``0.5 * pixel + 0.5 * colour``
truncated to uint8, JAX's formula bit for bit. The label is drawn with a
small built-in 5 x 7 bitmap font (capitals, digits, ``:._-``) where JAX
calls ``cv2.putText``: the text differs from JAX's, nothing else does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

# JAX's palette, used as BGR as OpenCV uses it there
PALETTE = [
    (220, 20, 60), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255),
    (0, 255, 255), (119, 11, 32), (0, 60, 100), (0, 80, 100), (0, 0, 230),
]

_GLYPHS = {
    "0": (" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "),
    "1": ("  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "),
    "2": (" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"),
    "3": ("#####", "   # ", "  #  ", "   # ", "    #", "#   #", " ### "),
    "4": ("   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "),
    "5": ("#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "),
    "6": ("  ## ", " #   ", "#    ", "#### ", "#   #", "#   #", " ### "),
    "7": ("#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "),
    "8": (" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "),
    "9": (" ### ", "#   #", "#   #", " ####", "    #", "   # ", " ##  "),
    "A": (" ### ", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"),
    "B": ("#### ", "#   #", "#   #", "#### ", "#   #", "#   #", "#### "),
    "C": (" ### ", "#   #", "#    ", "#    ", "#    ", "#   #", " ### "),
    "D": ("#### ", "#   #", "#   #", "#   #", "#   #", "#   #", "#### "),
    "E": ("#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#####"),
    "F": ("#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#    "),
    "G": (" ### ", "#   #", "#    ", "# ###", "#   #", "#   #", " ####"),
    "H": ("#   #", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"),
    "I": (" ### ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "),
    "J": ("  ###", "   # ", "   # ", "   # ", "   # ", "#  # ", " ##  "),
    "K": ("#   #", "#  # ", "# #  ", "##   ", "# #  ", "#  # ", "#   #"),
    "L": ("#    ", "#    ", "#    ", "#    ", "#    ", "#    ", "#####"),
    "M": ("#   #", "## ##", "# # #", "# # #", "#   #", "#   #", "#   #"),
    "N": ("#   #", "#   #", "##  #", "# # #", "#  ##", "#   #", "#   #"),
    "O": (" ### ", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "),
    "P": ("#### ", "#   #", "#   #", "#### ", "#    ", "#    ", "#    "),
    "Q": (" ### ", "#   #", "#   #", "#   #", "# # #", "#  # ", " ## #"),
    "R": ("#### ", "#   #", "#   #", "#### ", "# #  ", "#  # ", "#   #"),
    "S": (" ####", "#    ", "#    ", " ### ", "    #", "    #", "#### "),
    "T": ("#####", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "),
    "U": ("#   #", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "),
    "V": ("#   #", "#   #", "#   #", "#   #", "#   #", " # # ", "  #  "),
    "W": ("#   #", "#   #", "#   #", "# # #", "# # #", "# # #", " # # "),
    "X": ("#   #", "#   #", " # # ", "  #  ", " # # ", "#   #", "#   #"),
    "Y": ("#   #", "#   #", " # # ", "  #  ", "  #  ", "  #  ", "  #  "),
    "Z": ("#####", "    #", "   # ", "  #  ", " #   ", "#    ", "#####"),
    ":": ("     ", "  #  ", "  #  ", "     ", "  #  ", "  #  ", "     "),
    ".": ("     ", "     ", "     ", "     ", "     ", " ##  ", " ##  "),
    "_": ("     ", "     ", "     ", "     ", "     ", "     ", "#####"),
    "-": ("     ", "     ", "     ", "#####", "     ", "     ", "     "),
}
FONT = {c: np.array([[ch == "#" for ch in row] for row in rows]) for c, rows in _GLYPHS.items()}
GLYPH_H, GLYPH_W, ADVANCE = 7, 5, 6


def draw_box(vis: np.ndarray, box, color) -> None:
    """The outline ``cv2.rectangle(vis, (x1, y1), (x2, y2), color, 2)``
    draws: bands three pixels wide centred on each edge, over the edge's
    own span, so that the four outer corner pixels stay untouched."""
    x1, y1, x2, y2 = [int(v) for v in box]
    x1, x2 = min(x1, x2), max(x1, x2)
    y1, y2 = min(y1, y2), max(y1, y2)
    h, w = vis.shape[:2]
    ys = np.arange(max(y1 - 1, 0), min(y2 + 2, h))
    xs = np.arange(max(x1 - 1, 0), min(x2 + 2, w))
    if not len(ys) or not len(xs):
        return
    yy, xx = ys[:, None], xs[None, :]
    near_v = ((np.abs(xx - x1) <= 1) | (np.abs(xx - x2) <= 1)) & (yy >= y1) & (yy <= y2)
    near_h = ((np.abs(yy - y1) <= 1) | (np.abs(yy - y2) <= 1)) & (xx >= x1) & (xx <= x2)
    region = vis[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
    region[near_v | near_h] = color


def draw_text(vis: np.ndarray, text: str, origin, color) -> None:
    """``text`` in the 5 x 7 font, its baseline's left end at ``origin``
    (x, y) as ``cv2.putText`` takes it; characters the font lacks are
    blank, letters drawn as capitals; clipped to the image."""
    x0, y0 = int(origin[0]), int(origin[1]) - GLYPH_H + 1
    h, w = vis.shape[:2]
    for i, ch in enumerate(text.upper()):
        glyph = FONT.get(ch)
        if glyph is None:
            continue
        gx = x0 + i * ADVANCE
        ya, yb = max(y0, 0), min(y0 + GLYPH_H, h)
        xa, xb = max(gx, 0), min(gx + GLYPH_W, w)
        if ya < yb and xa < xb:
            vis[ya:yb, xa:xb][glyph[ya - y0:yb - y0, xa - gx:xb - gx]] = color


def draw_predictions(img: np.ndarray, pred: Dict[str, Any],
                     classes: Optional[Sequence[str]] = None) -> np.ndarray:
    """Boxes, labels and masks drawn on a copy of ``img`` (HWC BGR, cast to
    uint8). ``pred``: ``bboxes`` (xyxy), ``scores``, ``labels`` and, where
    present, ``masks`` (N, H, W); ``classes`` names the labels."""
    vis = np.asarray(img).astype(np.uint8).copy()
    masks = pred.get("masks")
    for i, (box, score, label) in enumerate(zip(pred["bboxes"], pred["scores"], pred["labels"])):
        color = PALETTE[int(label) % len(PALETTE)]
        draw_box(vis, box, color)
        name = (classes[int(label)] if classes is not None and int(label) < len(classes)
                else str(int(label)))
        draw_text(vis, f"{name}:{score:.2f}", (int(box[0]), max(int(box[1]) - 4, 10)), color)
        if masks is not None and i < len(masks):
            m = np.asarray(masks[i]).astype(bool)
            vis[m] = (0.5 * vis[m] + 0.5 * np.asarray(color)).astype(np.uint8)
    return vis
