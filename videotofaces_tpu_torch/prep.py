"""Input validation and path discovery (host-side, stdlib only).

Behavioral contract: reference prep.py — option whitelists (prep.py:39-44),
cluster-spec parsing (int / "a,b,c" / "a-b", prep.py:48-66), reference-image
directory scanning with the out_dir/ref fallback (prep.py:69-105),
grouping-input discovery with the faces/ fallback (prep.py:108-120), and
video-list building from a .txt / file / directory (prep.py:123-146). Errors
are printed and signalled by falsy returns, matching the reference's
non-raising CLI behavior. One deliberate relaxation: any model may pair with
any style (the reference hard-couples them, which rejects useful combos like
anime + YOLO + ViT-L — baseline config 3); crossing the usual pairing prints
a NOTE instead of failing.
"""

import os
import os.path as osp

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")

# every enumerated option in one table, checked uniformly
_CHOICES = {
    "mode": ("full", "detection", "grouping"),
    "style": ("live", "anime"),
    "group_mode": ("clustering", "classification"),
    "video_reader": ("opencv", "decord"),
    "det_model": ("default", "yolo", "mtcnn", "rcnn"),
    "enc_model": ("default", "facenet_vgg", "facenet_casia", "vit_b", "vit_l"),
}

# the pairings the published checkpoints were trained for; others only warn
_USUAL_DET = {"live": ("yolo", "mtcnn"), "anime": ("rcnn",)}
_USUAL_ENC = {"live": ("facenet_vgg", "facenet_casia"), "anime": ("vit_b", "vit_l")}


def get_img_paths(target_dir):
    if not osp.isdir(target_dir):
        return []
    return sorted(e.path for e in os.scandir(target_dir)
                  if e.is_file() and e.name.lower().endswith(IMG_EXTENSIONS))


def check_limited_option(val, arg_name, possible_vals=None):
    possible_vals = possible_vals if possible_vals is not None else _CHOICES[arg_name]
    if val in possible_vals:
        return True
    print('ERROR: unknown %s. Available options are %s'
          % (arg_name, ', '.join('"%s"' % v for v in possible_vals)))
    return False


def _check_paths(mode, input_path, out_dir):
    ok = True
    if input_path and not osp.exists(input_path):
        print("ERROR: specified input_path doesn't exist. Please provide a valid path "
              "to a file, a directory with files, or a .txt file with full paths inside")
        ok = False
    if out_dir and not osp.isdir(out_dir):
        print("ERROR: specified out_dir doesn't exist or isn't a directory. "
              "Please provide a valid path to a directory")
        ok = False
    if not input_path:
        if mode != "grouping":
            print("ERROR: please specify input_path")
            ok = False
        elif not out_dir:
            print("ERROR: for grouping, please specify either out_dir or the same "
                  "input_path used during detection")
            ok = False
    return ok


def validate_args(mode, input_path, out_dir, style, group_mode, video_reader,
                  det_model, enc_model):
    if not check_limited_option(mode, "mode"):
        return False
    ok = _check_paths(mode, input_path, out_dir)
    for name, val in [("style", style), ("group_mode", group_mode),
                      ("video_reader", video_reader), ("det_model", det_model),
                      ("enc_model", enc_model)]:
        # no short-circuit: report EVERY invalid option in one pass
        ok = check_limited_option(val, name) and ok
    if not ok:
        return False

    if det_model != "default" and det_model not in _USUAL_DET[style]:
        print('NOTE: det_model "%s" is unusual for style "%s" (trained on %s '
              'content)' % (det_model, style,
                            "anime" if det_model == "rcnn" else "live-action"))
    if enc_model != "default" and enc_model not in _USUAL_ENC[style]:
        print('NOTE: enc_model "%s" is unusual for style "%s"' % (enc_model, style))
    return True


def get_clusters(spec):
    """Cluster-count spec -> sorted list of candidate k values. Accepts a
    positive int, an enumeration "a,b,c", or an inclusive range "a-b"."""
    if not spec:
        return list(range(2, 9))
    if isinstance(spec, int):
        if spec > 0:
            return [spec]
    elif not isinstance(spec, str):
        pass  # unsupported type -> the printed ERROR below (never raise)
    elif spec.isdigit():
        # a bare number from the CLI arrives as a string; the reference
        # errors on it (prep.py:48-66 only handles int / "a,b,c" / "a-b"),
        # which makes `--clusters 4` unusable — accepted here
        if int(spec) > 0:
            return [int(spec)]
    elif "," in spec:
        parts = spec.split(",")
        # positivity matches the other branches (the reference accepts "0,5"
        # here and then crashes inside sklearn; its own message promises a
        # natural number)
        if all(p.isdigit() and int(p) > 0 for p in parts):
            return sorted({int(p) for p in parts})
    elif spec.count("-") == 1:
        lo, _, hi = spec.partition("-")
        if lo.isdigit() and hi.isdigit() and 0 < int(lo) < int(hi):
            return list(range(int(lo), int(hi) + 1))
    print('ERROR: incorrent value for clusters. Please specify a natural number or a '
          'string either as an enumeration "C1,C2,C3,C4" or a range "A-B" where 0 < A < B')
    return None


def _resolve_ref_dir(ref_dir, out_dir):
    if ref_dir:
        if osp.isdir(ref_dir):
            return ref_dir
        print("ERROR: specified ref_dir doesn't exist or isn't a directory. "
              "Please provide a valid path to a directory")
        return None
    fallback = osp.join(out_dir, "ref")
    if osp.isdir(fallback):
        print('NOTE: ref_dir is unspecified, but found "ref" folder inside out_dir. '
              'Will search for reference images there')
        return fallback
    print('ERROR: for group_mode="classification", ref_dir needs to be specified')
    return None


def get_class_ref(ref_dir, out_dir):
    """Scan ref_dir subfolders -> [(class_name, [image_paths])]."""
    explanation = ("Please prepare a directory with 1 or more subfolders representing "
                   "groups, each with 1 or more reference images inside")
    resolved = _resolve_ref_dir(ref_dir, out_dir)
    if not resolved:
        if not ref_dir:
            print(explanation)
        return None

    classes = sorted(e.name for e in os.scandir(resolved) if e.is_dir())
    if not classes:
        print("ERROR: specified ref_dir doesn't contain any subfolders")
        print(explanation)
        return None

    scanned = [(c, get_img_paths(osp.join(resolved, c))) for c in classes]
    refs = [(c, imgs) for (c, imgs) in scanned if imgs]
    if not refs:
        print("ERROR: none of the ref_dir's subfolders contain any images")
        print("Supported extensions are: %s" % ", ".join(IMG_EXTENSIONS))
        return None
    for c, imgs in scanned:
        if not imgs:
            print('WARNING: ref_dir\'s subfolder "%s" doesn\'t contain any '
                  'images. During classification, this class will be ignored' % c)
    return refs


def get_paths_for_grouping(out_dir):
    """Images to group: prefer out_dir/faces (the detection output layout),
    fall back to out_dir itself."""
    for tdir in (osp.join(out_dir, "faces"), out_dir):
        paths = get_img_paths(tdir)
        if paths:
            print("Found %u images at: %s" % (len(paths), tdir))
            return paths
    print("ERROR: no image files for grouping found at: %s" % out_dir)
    return None


def get_video_list(input_path, ext):
    """Video list from a .txt manifest, a single file, or a directory."""
    if osp.isfile(input_path):
        if not input_path.lower().endswith(".txt"):
            return [input_path]
        with open(input_path) as f:
            files = [ln.strip() for ln in f.read().splitlines() if osp.isfile(ln.strip())]
        if not files:
            print("ERROR: specified .txt file doesn't contain any valid paths. Please "
                  "provide a file with paths to videos, each on a separate line")
        return files

    files = sorted(e.path for e in os.scandir(input_path) if e.is_file())
    if not files:
        print("ERROR: no files are found in the specified input directory")
    elif ext:
        # normalize the user's spec (the files are lowercased for comparison,
        # so "MP4" or ".mp4" would otherwise match nothing — the reference
        # shares this trap, detection.py-era prep.py:141-143)
        allowed = {e.lower().lstrip(".") for e in ext.split(";")}
        files = [p for p in files if p.lower().rsplit(".", 1)[-1] in allowed]
        if not files:
            print("ERROR: no files with specified extensions (%s) are found in the "
                  "input directory" % ext)
    return files
