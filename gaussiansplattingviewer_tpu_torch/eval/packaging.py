"""Dataset packaging + integrity checks (ref zip_files.py, unzip*.py,
check_files.py)."""

from __future__ import annotations

import os
import zipfile


def check_scene_files(root: str, expected: int = 100,
                      subdirs=("left", "right", "depth")) -> dict:
    """Verify each scene folder holds ``expected`` files per subdir — the
    reference checks 100 depth files per scene (check_files.py:14-27).
    Returns {scene: {subdir: count}} for scenes with any mismatch."""
    bad = {}
    for scene in sorted(os.listdir(root)):
        sdir = os.path.join(root, scene)
        if not os.path.isdir(sdir):
            continue
        counts = {}
        for sub in subdirs:
            p = os.path.join(sdir, sub)
            counts[sub] = (
                len([f for f in os.listdir(p) if f.endswith(".png")])
                if os.path.isdir(p)
                else 0
            )
        if any(c != expected for c in counts.values()):
            bad[scene] = counts
    return bad


def zip_scene(scene_dir: str, out_zip: str | None = None) -> str:
    """Zip one scene folder (ref zip_files.py)."""
    scene_dir = os.path.normpath(scene_dir)
    if out_zip is None:
        out_zip = scene_dir + ".zip"
    base = os.path.dirname(scene_dir)
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, _, files in os.walk(scene_dir):
            for f in files:
                full = os.path.join(dirpath, f)
                zf.write(full, os.path.relpath(full, base))
    return out_zip


def zip_all_scenes(root: str) -> list[str]:
    return [
        zip_scene(os.path.join(root, s))
        for s in sorted(os.listdir(root))
        if os.path.isdir(os.path.join(root, s))
    ]


def unzip_all(src_dir: str, dest_dir: str) -> list[str]:
    """Extract every .zip in src_dir into dest_dir (ref unzip.py,
    unzip_training_data.py)."""
    os.makedirs(dest_dir, exist_ok=True)
    out = []
    for f in sorted(os.listdir(src_dir)):
        if f.endswith(".zip"):
            with zipfile.ZipFile(os.path.join(src_dir, f)) as zf:
                zf.extractall(dest_dir)
            out.append(f)
    return out
