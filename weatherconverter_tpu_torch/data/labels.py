"""Cityscapes label taxonomy and the train-id encode/decode lookups (port of
weatherconverter_tpu/data/labels.py, numpy only).

A copy, because the port imports nothing of the JAX package: the canonical
34-entry table, a 256-entry id -> train-id lookup (ignored ids become 255,
never 0) and the train-id colour map. The tests hold every table and
function equal to the JAX module's.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

Label = namedtuple(
    "Label",
    ["name", "id", "trainId", "category", "categoryId", "hasInstances", "ignoreInEval", "color"],
)

# The canonical Cityscapes 34-entry table (public; same content as
# reference labels.py:55-92).
LABELS = [
    Label("unlabeled",            0, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("ego vehicle",          1, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("rectification border", 2, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("out of roi",           3, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("static",               4, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("dynamic",              5, 255, "void",         0, False, True,  (111, 74, 0)),
    Label("ground",               6, 255, "void",         0, False, True,  (81, 0, 81)),
    Label("road",                 7,   0, "flat",         1, False, False, (128, 64, 128)),
    Label("sidewalk",             8,   1, "flat",         1, False, False, (244, 35, 232)),
    Label("parking",              9, 255, "flat",         1, False, True,  (250, 170, 160)),
    Label("rail track",          10, 255, "flat",         1, False, True,  (230, 150, 140)),
    Label("building",            11,   2, "construction", 2, False, False, (70, 70, 70)),
    Label("wall",                12,   3, "construction", 2, False, False, (102, 102, 156)),
    Label("fence",               13,   4, "construction", 2, False, False, (190, 153, 153)),
    Label("guard rail",          14, 255, "construction", 2, False, True,  (180, 165, 180)),
    Label("bridge",              15, 255, "construction", 2, False, True,  (150, 100, 100)),
    Label("tunnel",              16, 255, "construction", 2, False, True,  (150, 120, 90)),
    Label("pole",                17,   5, "object",       3, False, False, (153, 153, 153)),
    Label("polegroup",           18, 255, "object",       3, False, True,  (153, 153, 153)),
    Label("traffic light",       19,   6, "object",       3, False, False, (250, 170, 30)),
    Label("traffic sign",        20,   7, "object",       3, False, False, (220, 220, 0)),
    Label("vegetation",          21,   8, "nature",       4, False, False, (107, 142, 35)),
    Label("terrain",             22,   9, "nature",       4, False, False, (152, 251, 152)),
    Label("sky",                 23,  10, "sky",          5, False, False, (70, 130, 180)),
    Label("person",              24,  11, "human",        6, True,  False, (220, 20, 60)),
    Label("rider",               25,  12, "human",        6, True,  False, (255, 0, 0)),
    Label("car",                 26,  13, "vehicle",      7, True,  False, (0, 0, 142)),
    Label("truck",               27,  14, "vehicle",      7, True,  False, (0, 0, 70)),
    Label("bus",                 28,  15, "vehicle",      7, True,  False, (0, 60, 100)),
    Label("caravan",             29, 255, "vehicle",      7, True,  True,  (0, 0, 90)),
    Label("trailer",             30, 255, "vehicle",      7, True,  True,  (0, 0, 110)),
    Label("train",               31,  16, "vehicle",      7, True,  False, (0, 80, 100)),
    Label("motorcycle",          32,  17, "vehicle",      7, True,  False, (0, 0, 230)),
    Label("bicycle",             33,  18, "vehicle",      7, True,  False, (119, 11, 32)),
]

NUM_TRAIN_CLASSES = 19
IGNORE_INDEX = 255

TRAIN_CLASS_NAMES = [l.name for l in LABELS if l.trainId not in (255, -1)]


def get_train_ids() -> list[int]:
    """(reference: labels.py:95-100) — ids of the 19 evaluated classes."""
    return [l.id for l in LABELS if not l.ignoreInEval]


def _build_id_to_train_id() -> np.ndarray:
    """256-entry LUT: raw label id -> train id (255 for ignored), so
    encode_target works on uint8 label PNGs with a single gather
    (reference builds a 34+ lut at acdc.py:82, lut[id]=trainId)."""
    lut = np.full((256,), IGNORE_INDEX, dtype=np.uint8)
    for l in LABELS:
        if 0 <= l.id < 256:
            lut[l.id] = l.trainId if l.trainId != -1 else IGNORE_INDEX
    return lut


def _build_train_id_to_color() -> np.ndarray:
    """(NUM_TRAIN_CLASSES+1, 3) color map; row 19 (the remapped 255) is black
    (reference: acdc.py:78-80,140-143)."""
    colors = np.zeros((NUM_TRAIN_CLASSES + 1, 3), dtype=np.uint8)
    for l in LABELS:
        if l.trainId not in (255, -1):
            colors[l.trainId] = l.color
    return colors


ID_TO_TRAIN_ID = _build_id_to_train_id()
TRAIN_ID_TO_COLOR = _build_train_id_to_color()


def encode_target(target: np.ndarray) -> np.ndarray:
    """Raw Cityscapes ids -> train ids (reference: acdc.py:135-138)."""
    return ID_TO_TRAIN_ID[np.asarray(target, dtype=np.uint8)]


def decode_target(target: np.ndarray) -> np.ndarray:
    """Train ids -> RGB colors; 255 renders black (reference: acdc.py:140-143)."""
    t = np.asarray(target).copy()
    t[t == IGNORE_INDEX] = NUM_TRAIN_CLASSES
    return TRAIN_ID_TO_COLOR[t]
