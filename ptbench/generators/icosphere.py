"""An icosahedron whose faces are split in four `subdiv` times, every new
vertex pushed onto the sphere: 20 * 4**subdiv outward-wound faces
(normal = (v1 - v0) x (v2 - v0) points out)."""

from __future__ import annotations

import numpy as np


def generate(center, radius, subdiv):
    """-> (vertices f64 [V, 3], faces i64 [F, 3])."""
    g = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, g, 0], [1, g, 0], [-1, -g, 0], [1, -g, 0],
                  [0, -1, g], [0, 1, g], [0, -1, -g], [0, 1, -g],
                  [g, 0, -1], [g, 0, 1], [-g, 0, -1], [-g, 0, 1]],
                 np.float64)
    verts = list(v / np.linalg.norm(v, axis=1, keepdims=True))
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
             [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
             [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
             [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(int(subdiv)):
        mids = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mids[key] = len(verts) - 1
            return mids[key]

        split = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            split += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = split
    return (np.asarray(verts) * float(radius)
            + np.asarray(center, np.float64), np.asarray(faces, np.int64))
