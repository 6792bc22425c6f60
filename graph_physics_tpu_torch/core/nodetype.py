"""Node taxonomy shared by datasets, models and losses.

Copy of graph_physics_tpu/core/nodetype.py:NodeType (the integer codes are
part of the dataset contract and of the one-hot appended to model inputs).
"""

import enum


class NodeType(enum.IntEnum):
    NORMAL = 0
    OBSTACLE = 1
    AIRFOIL = 2
    HANDLE = 3
    INFLOW = 4
    OUTFLOW = 5
    WALL_BOUNDARY = 6
    SIZE = 9
