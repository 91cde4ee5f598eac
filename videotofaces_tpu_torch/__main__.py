"""`python -m videotofaces_tpu_torch` — CLI with flag-for-flag parity to the
reference (`python -m videotofaces`, __main__.py:21-57): dashes map to the
`video_to_faces` kwargs 1:1 and args are passed straight through."""

import argparse

from .api import video_to_faces


class HelpFormatter(argparse.HelpFormatter):
    def __init__(self, prog):
        super().__init__(prog, max_help_position=40, width=120)

    def _format_action_invocation(self, action):
        if not action.option_strings or action.nargs == 0:
            return super()._format_action_invocation(action)
        metavar = self._format_args(action, self._get_default_metavar_for_optional(action))
        return ", ".join(action.option_strings) + " " + metavar


def build_parser():
    p = argparse.ArgumentParser(prog="videotofaces_tpu_torch", formatter_class=HelpFormatter)
    p.add_argument("-i", "--input-path", metavar="PATH",
                   help="video file, directory of videos, or .txt manifest of paths")
    p.add_argument("-e", "--input-ext", metavar="EXTENSIONS",
                   help="semicolon-separated extension filter when -i is a directory")
    p.add_argument("-o", "--out-dir", metavar="PATH",
                   help='output directory ("faces"/"intermediate" created under it); '
                        "defaults to the input directory")
    p.add_argument("-op", "--out-prefix", metavar="TEXT", default="",
                   help="prefix added to every saved face image")
    p.add_argument("-s", "--style", metavar="TEXT", required=True,
                   help='"live" or "anime" — selects the model family')
    p.add_argument("-m", "--mode", metavar="TEXT", default="full",
                   help='"full", "detection" or "grouping"')
    p.add_argument("-d", "--device", metavar="TEXT",
                   help='"cuda" (the default) or "cpu"; without a CUDA device pass "cpu"')
    p.add_argument("--save-frames", action="store_true",
                   help="save annotated frames (green=passed, red=rejected boxes) under "
                        "intermediate/frames for detector tuning")
    p.add_argument("--save-rejects", action="store_true",
                   help="save rejected face crops + log_rejects.csv under intermediate/")
    p.add_argument("--save-dupes", action="store_true",
                   help="keep duplicate crops in intermediate/dupesN with log_dupesN.csv "
                        "instead of deleting them")
    p.add_argument("--video-step", metavar="SEC", type=float, default=1,
                   help="sampling interval between processed frames, in seconds")
    p.add_argument("--video-fragment", metavar="MIN", type=float, nargs=2,
                   help="process only this segment, two values in minutes (start end)")
    p.add_argument("--video-area", metavar="PX", type=int, nargs=4,
                   help="process only this rectangle: x1 y1 x2 y2 in pixels")
    p.add_argument("--video-reader", metavar="TEXT", default="opencv",
                   choices=["opencv", "decord"],
                   help='"opencv" (default) or "decord" for decoding')
    p.add_argument("--det-model", metavar="TEXT", default="default",
                   help='"yolo"/"mtcnn" for live, "rcnn" for anime; "default" picks per style '
                        '(rcnn for anime, yolo for live)')
    p.add_argument("--det-batch-size", metavar="INT", type=int, default=4,
                   help="frames per detector forward pass")
    p.add_argument("--det-min-score", metavar="FLOAT", type=float, default=0.4,
                   help="reject faces with detector confidence below this")
    p.add_argument("--det-min-size", metavar="PX", type=int, default=50,
                   help="reject faces with width or height below this (pre-scaling)")
    p.add_argument("--det-min-border", metavar="PX", type=int, default=5,
                   help="reject faces closer than this to any frame border")
    p.add_argument("--det-scale", metavar="N", type=float, nargs=4,
                   default=[1.5, 1.5, 2.2, 1.2],
                   help="box expansion factors (left right up down) about the center")
    p.add_argument("--det-square", action="store_true",
                   help="square each face area after --det-scale expansion")
    p.add_argument("--hash-thr", metavar="INT", type=int, default=8,
                   help="average-hash distance for duplicate marking (parts 1-2); "
                        "-1 disables the hash dedup")
    p.add_argument("--enc-model", metavar="TEXT", default="default",
                   help='"facenet_vgg"/"facenet_casia" for live, "vit_b"/"vit_l" for anime')
    p.add_argument("--enc-batch-size", metavar="INT", type=int, default=16,
                   help="images per encoder forward pass")
    p.add_argument("--enc-area", metavar="N", type=float, nargs=4,
                   help="fractional crop (px1 py1 px2 py2 in 0..1) applied before encoding")
    p.add_argument("--enc-dup-thr", metavar="FLOAT", type=float, default=0.25,
                   help="cosine-distance threshold for embedding dedup (part 3); -1 disables")
    p.add_argument("--group-mode", metavar="TEXT", default="clustering",
                   help='"clustering" (K-means) or "classification" (reference images)')
    p.add_argument("--clusters", metavar="TEXT", default="2-9",
                   help='cluster counts to try: a number, "a,b,c", or a range "A-B"; best '
                        "by silhouette score wins")
    p.add_argument("--clusters-save-all", action="store_true",
                   help="save grouping results for every candidate cluster count under G<K>/")
    p.add_argument("--random-state", metavar="INT", type=int, default=0,
                   help="K-means random state for reproducible clustering")
    p.add_argument("--ref-dir", metavar="PATH",
                   help="classification mode: folder of per-class subfolders with "
                        "reference images")
    p.add_argument("--enc-oth-thr", metavar="FLOAT", type=float, default=0.9,
                   help='classification mode: distance above which a face goes to "other"; '
                        "-1 disables the other class")
    p.add_argument("--group-log", action="store_true",
                   help="write log_clustering.csv / log_classification.csv under faces/")
    p.add_argument("--enc-from-memory", action="store_true",
                   help="full mode: encode crops straight from memory instead of "
                        "re-reading the saved JPEGs (faster; the encoder sees "
                        "pre-compression pixels)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    video_to_faces(**vars(args))


if __name__ == "__main__":
    main()
