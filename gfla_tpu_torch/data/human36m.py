"""Human3.6M data access (the port's copy of gfla_tpu/data/human36m.py, the
original's util/human36m.py): VideoPose3D-format NPZ loading, the camera
tables (data/camera.py) and the sequence list of the keypoint datasets."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from gfla_tpu_torch.data.camera import (  # noqa: F401  (re-exported surface)
    H36M_EXTRINSICS,
    H36M_INTRINSICS,
    camera_to_world,
    image_coordinates,
    init_cameras_param,
    normalize_screen_coordinates,
    project_to_2d,
    project_to_2d_linear,
    world_to_camera,
)

SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]

# 32-joint -> 17-joint selection (keypoint_dataset.py:133)
H36M_17_FROM_32 = [0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27]


def init_position_data(path: str) -> Tuple[Dict, str]:
    """Load a VideoPose3D NPZ: ({subject: {action: {camera: (T, K, C)}}},
    '2d'), or for 3-D positions ({subject: {action: (T, K, 3)}}, '3d')
    (human36m.py:197-215)."""
    file_data = np.load(path, allow_pickle=True)
    if "positions_2d" in file_data:
        raw = file_data["positions_2d"].item()
        data_type = "2d"
    elif "positions_3d" in file_data:
        raw = file_data["positions_3d"].item()
        data_type = "3d"
    else:
        raise ValueError(f"{path}: no positions_2d/positions_3d key")
    data: Dict = {}
    for subject, actions in raw.items():
        data[subject] = {}
        for action, positions in actions.items():
            if data_type == "2d":
                data[subject][action] = {
                    str(i): positions[i] for i in range(len(positions))
                }
            else:
                data[subject][action] = positions
    return data, data_type


def init_video_list(path_input: str, path_gt: str,
                    exclude_subjects: List[str]) -> List[Dict]:
    """The (subject, action, camera) sequences present in both archives,
    the held-out subjects excluded (human36m.py:240-263)."""
    inp, _ = init_position_data(path_input)
    gt, _ = init_position_data(path_gt)
    out = []
    for subject in inp:
        if subject not in gt or subject in exclude_subjects:
            continue
        for action in inp[subject]:
            if action not in gt[subject]:
                continue
            for camera in inp[subject][action]:
                out.append(
                    {"subject": subject, "action": action, "camera": camera}
                )
    return out


def check_dataset(data_gt, data_input, data_list, gt_data_type) -> List[Dict]:
    """Drop the sequences whose gt and input lengths differ by more than 1%
    (human36m.py:265-279)."""
    out = []
    for seq in data_list:
        if gt_data_type == "2d":
            vg = data_gt[seq["subject"]][seq["action"]][seq["camera"]]
        else:
            vg = data_gt[seq["subject"]][seq["action"]]
        vi = data_input[seq["subject"]][seq["action"]][seq["camera"]]
        if abs(vg.shape[0] - vi.shape[0]) / vg.shape[0] <= 0.01:
            out.append(seq)
    return out
