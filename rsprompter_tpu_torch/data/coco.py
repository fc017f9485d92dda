"""COCO-format instance-segmentation datasets (no pycocotools dependency).

The port's copy of ``rsprompter_tpu/data/coco.py`` (``poly_to_mask`` :21,
``rle_dict_to_mask`` :36, ``CocoDataset`` :44 with ``load_raw`` :112 and
``__getitem__`` :159, and the three RSPrompter datasets :170-190, registered
under the same names), with
OpenCV replaced: images are read by ``data/io.py`` and polygons rasterised
by ``data/polygon.py``, each the same bytes and pixels as OpenCV. The image
stays uint8 BGR (``make_batch`` takes uint8; the train transforms,
``data/transforms.py``, take it to float where JAX's float32 decode would
give the same values); every GT array is the JAX package's. Without a
pipeline (the test side) a sample is ``load_raw``'s: the evaluation path
resizes on the device.

Behavior parity: reference ``mmdet/datasets/coco.py:14`` (``CocoDataset``) and
the three RSPrompter dataset classes (``mmdet/rsprompter/datasets.py:5,17,25``)
— WHU buildings, NWPU VHR-10, SSDD SAR ships, which only override METAINFO.
Annotations are plain COCO json (shipped in the reference's ``data/`` tree).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from rsprompter_tpu_torch.core.registry import DATASETS
from rsprompter_tpu_torch.data.io import imread
from rsprompter_tpu_torch.data.polygon import fill_poly
from rsprompter_tpu_torch.evaluation.rle import RLE, decode_mask


def poly_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon list -> uint8 binary mask (``cv2.fillPoly``'s pixels)."""
    mask = np.zeros((h, w), np.uint8)
    pts = [
        np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        fill_poly(mask, pts)
    return mask


def rle_dict_to_mask(rle: Dict, h: int, w: int) -> np.ndarray:
    """Uncompressed COCO RLE dict -> binary mask."""
    return decode_mask(RLE(h, w, np.asarray(rle["counts"], np.uint32)))


@DATASETS.register_module()
class CocoDataset:
    METAINFO: Dict[str, Any] = {"classes": (), "palette": ()}

    def __init__(
        self,
        ann_file: str,
        data_root: str = "",
        data_prefix: Optional[Dict[str, str]] = None,
        pipeline: Sequence = (),
        test_mode: bool = False,
        filter_empty_gt: bool = False,
        indices: Optional[Sequence[int]] = None,
        metainfo: Optional[Dict] = None,
    ):
        self.data_root = data_root
        self.img_prefix = (data_prefix or {}).get("img", "")
        self.test_mode = test_mode
        self.metainfo = dict(self.METAINFO)
        if metainfo:
            self.metainfo.update(metainfo)
        self.pipeline = list(pipeline)

        ann_path = ann_file
        if data_root and not os.path.isabs(ann_path):
            ann_path = os.path.join(data_root, ann_file)
        with open(ann_path) as f:
            coco = json.load(f)

        cats = sorted(coco["categories"], key=lambda c: c["id"])
        classes = self.metainfo.get("classes") or tuple(c["name"] for c in cats)
        self.metainfo["classes"] = tuple(classes)
        name_to_label = {n: i for i, n in enumerate(classes)}
        self.cat_id_to_label = {
            c["id"]: name_to_label[c["name"]]
            for c in cats
            if c["name"] in name_to_label
        }
        self.label_to_cat_id = {v: k for k, v in self.cat_id_to_label.items()}

        anns_by_img: Dict[int, List[Dict]] = {}
        for a in coco["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.data_list: List[Dict] = []
        for img in coco["images"]:
            anns = anns_by_img.get(img["id"], [])
            if filter_empty_gt and not test_mode and not anns:
                continue
            self.data_list.append(
                dict(
                    img_id=img["id"],
                    img_path=os.path.join(
                        self.data_root, self.img_prefix, img["file_name"]
                    ),
                    height=img["height"],
                    width=img["width"],
                    anns=anns,
                )
            )
        if indices is not None:
            if isinstance(indices, int):
                self.data_list = self.data_list[:indices]
            else:
                self.data_list = [self.data_list[i] for i in indices]

    def __len__(self) -> int:
        return len(self.data_list)

    def load_raw(self, idx: int) -> Dict[str, Any]:
        """One sample: the uint8 BGR image and its GT at the original size."""
        info = self.data_list[idx]
        img = imread(info["img_path"])  # BGR, HWC, uint8
        h, w = img.shape[:2]

        bboxes, labels, masks, ignores, areas = [], [], [], [], []
        for a in info["anns"]:
            if a["category_id"] not in self.cat_id_to_label:
                continue
            x, y, bw, bh = a["bbox"]
            bboxes.append([x, y, x + bw, y + bh])
            labels.append(self.cat_id_to_label[a["category_id"]])
            ignores.append(bool(a.get("iscrowd", 0)))
            # COCO 'area' is the segmentation area, and is what pycocotools'
            # area-range ignore rule reads (cocoeval _prepare/evaluateImg);
            # bbox area is only a fallback for area-less annotations
            areas.append(float(a.get("area", bw * bh)))
            seg = a.get("segmentation")
            if isinstance(seg, list):
                masks.append(poly_to_mask(seg, h, w))
            elif isinstance(seg, dict):
                masks.append(rle_dict_to_mask(seg, h, w))
            else:
                masks.append(np.zeros((h, w), np.uint8))
        n = len(bboxes)
        return dict(
            img=img,
            img_id=info["img_id"],
            img_path=info["img_path"],
            ori_shape=(h, w),
            img_shape=(h, w),
            scale_factor=(1.0, 1.0),
            gt_bboxes=np.asarray(bboxes, np.float32).reshape(n, 4),
            gt_labels=np.asarray(labels, np.int64),
            gt_ignore_flags=np.asarray(ignores, bool),
            gt_areas=np.asarray(areas, np.float64),
            gt_masks=(
                np.stack(masks) if masks else np.zeros((0, h, w), np.uint8)
            ),
        )

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        sample = self.load_raw(idx)
        for t in self.pipeline:
            sample = t(sample)
            if sample is None:
                # filtered out (train-time): resample another index
                return self[np.random.randint(len(self))]
        return sample


@DATASETS.register_module()
class NWPUInsSegDataset(CocoDataset):
    METAINFO = {
        "classes": (
            "airplane", "ship", "storage_tank", "baseball_diamond",
            "tennis_court", "basketball_court", "ground_track_field",
            "harbor", "bridge", "vehicle",
        ),
        "palette": [
            (220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100),
            (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 255, 0), (0, 0, 255),
        ],
    }


@DATASETS.register_module()
class WHUInsSegDataset(CocoDataset):
    METAINFO = {"classes": ("building",), "palette": [(0, 255, 0)]}


@DATASETS.register_module()
class SSDDInsSegDataset(CocoDataset):
    METAINFO = {"classes": ("ship",), "palette": [(0, 0, 255)]}
