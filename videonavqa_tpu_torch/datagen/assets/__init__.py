"""In-tree copies of the benchmark's color-metadata tables.

These are the reference's *data* assets, shipped verbatim by necessity (their
values define the benchmark):

- ``colormap_coarse.csv`` — the SUNCG semantic-render palette: 94 coarse
  object classes -> RGB, consumed by semantic-frame analysis
  (reference colormap_coarse.csv, scripts/trajectory_gen.py:680-689);
- ``object_id_to_colors.npy`` — pickled {object node id: [color names]} ground
  truth used to attach color attributes to house objects
  (reference object_id_to_colors.npy, scripts/trajectory_gen.py:259-261).
"""

import os

_HERE = os.path.dirname(os.path.abspath(__file__))

COLORMAP_COARSE_CSV = os.path.join(_HERE, "colormap_coarse.csv")
OBJECT_ID_TO_COLORS_NPY = os.path.join(_HERE, "object_id_to_colors.npy")
