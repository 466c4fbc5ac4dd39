"""House3D/SUNCG backend adapter (external dependency).

The reference renders real SUNCG houses through a C++ House3D fork and reads
ground truth via the EmbodiedQA fork (scripts/trajectory_gen.py:12-16).
Neither ships with this framework; this adapter documents and implements the
integration seam so real-dataset generation plugs into the same pipeline the
synthetic backend uses:

    rooms = load_suncg_house(house3d_utils, house_id, obj_colors)
    scene = SceneGraph(rooms)
    renderer = House3DRenderer(env)           # wraps the C++ RenderAPI
    observer = TrajectoryObserver(scene, renderer,
                                  rgb_to_obj=load_semantic_colormap(csv_path))
    ...

The benchmark's color metadata ships in-tree (datagen/assets): the semantic
palette ``colormap_coarse.csv`` and the ``object_id_to_colors.npy`` ground
truth. tests/test_house3d_backend.py drives this whole seam against a mock
House3D environment.

Requirements (README.md:35-39 of the reference): the SUNCG dataset +
SUNCGtoolbox ``scn2scn`` (house.json -> house.obj meshes), the House3D fork,
and the EmbodiedQA fork's eqa_v1.json for house splits.
"""

from __future__ import annotations

import json
import subprocess

from videonavqa_tpu_torch.datagen.renderer import RenderMode
from videonavqa_tpu_torch.datagen.scene import HouseObject, HouseRoom


def load_obj_colors(path):
    """Object-id -> color-name mapping from either obj_colors.json or the
    object_id_to_colors.npy pickle the reference mirrors it in
    (scripts/trajectory_gen.py:217,259-261; README .MISSING_LARGE_BLOBS)."""
    if path.endswith(".npy"):
        import numpy as np

        return dict(np.load(path, allow_pickle=True).item())
    with open(path) as f:
        return json.load(f)


def load_suncg_house(house3d_utils, house_id, obj_colors):
    """HouseRoom ground truth from an initialized ``House3DUtils`` (the
    EmbodiedQA fork object exposing ``.rooms`` / ``.objects``,
    scripts/trajectory_gen.py:220-273)."""
    return suncg_house_to_rooms(house3d_utils.rooms, house3d_utils.objects,
                                house_id, obj_colors)


def suncg_house_to_rooms(rooms_meta, objects_meta, house_id, obj_colors):
    """Convert House3D-style room/object metadata into HouseRoom ground truth.

    rooms_meta: iterable of {'type': [str], 'bbox': {...}, 'nodes': [ids]};
    objects_meta: {'0_<node>': {'coarse_class', 'bbox', 'id'}} — the shapes
    House3DUtils exposes (scripts/trajectory_gen.py:216-273)."""
    rooms = []
    for room in rooms_meta:
        objs = []
        for node in room["nodes"]:
            meta = objects_meta.get("0_" + str(node))
            if meta is None:
                continue
            node_name = ".0_" + meta["id"][2:]
            objs.append(HouseObject(
                node=node_name,
                coarse_class=meta["coarse_class"],
                bbox=meta["bbox"],
                color=obj_colors.get(house_id + node_name)))
        rooms.append(HouseRoom(types=list(room["type"]), bbox=room["bbox"],
                               objects=objs))
    return rooms


def run_scn2scn(scn2scn_binary, house_json, house_obj):
    """SUNCGtoolbox mesh conversion
    (scripts/generate_questions_for_trajectories.py:75-84)."""
    subprocess.run([scn2scn_binary, house_json, house_obj], check=True)


class House3DRenderer:
    """Wraps a House3D Environment in the framework's renderer interface.

    Construct with an initialized ``House3D.Environment`` (the C++ OpenGL/EGL
    renderer from the fork); raises ImportError with instructions when the
    fork is absent.
    """

    def __init__(self, env, width=208, height=160):
        self.env = env
        self.width, self.height = width, height
        try:
            from House3D.objrender import RenderMode as H3DMode  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "House3D fork not installed — real-SUNCG generation needs the "
                "reference's external renderer (see module docstring); the "
                "SyntheticRenderer backend needs no external deps") from e
        self._modes = None

    def _set_pose(self, pose):
        x, _, z, yaw = pose
        self.env.cam.pos.x = x
        self.env.cam.pos.y = 1.2  # agent eye height (scripts/trajectory_gen.py:111)
        self.env.cam.pos.z = z
        self.env.cam.yaw = yaw
        self.env.cam.updateDirection()

    def render(self, pose, mode=RenderMode.RGB):
        import numpy as np
        from House3D.objrender import RenderMode as H3DMode

        self._set_pose(pose)
        h3d_mode = {RenderMode.RGB: H3DMode.RGB,
                    RenderMode.SEMANTIC: H3DMode.SEMANTIC,
                    RenderMode.DEPTH: H3DMode.DEPTH}[mode]
        self.env.set_render_mode(h3d_mode)
        img = np.array(self.env.render(), copy=False)
        if mode == RenderMode.DEPTH:
            return img[:, :, 0].astype(np.float32)
        return img.astype(np.int32) if mode == RenderMode.SEMANTIC else img
