"""Entry keys and packaged data paths of the port.

A copy of the keys of ``vltk_tpu/vars.py`` that the OCR processing chain,
the predictors, the FRCNN collate and the experiments read and write (the
port imports nothing of the JAX package), and the path of the port's own
copy of the BERT vocabulary.
"""

from __future__ import annotations

import os

BASEPATH = os.path.abspath(os.path.dirname(__file__))
LIBDATA = os.path.join(BASEPATH, "libdata")
VOCABPATH = os.path.join(LIBDATA, "vocab.txt")

text = "text"
tokenmap = "tokenmap"
tokenlabels = "tokenlabels"
labels = "labels"
label = "label"
size = "size"
rawsize = "rawsize"
scale = "wh_scale"
tokenbox = "tokenbox"
visual_attention_mask = "visual_attention_mask"
img = "image"
imgid = "imgid"
input_ids = "input_ids"
type_ids = "type_ids"
text_attention_mask = "text_attention_mask"
boxes = "boxes"
features = "features"
scores = "scores"
boxes_mask = "boxes_mask"

# text-side keys of a vision dataset renamed with a "v" prefix when joined
# with a vision-language dataset by image id (the ones the port reads)
VLOVERLAP = {text: "vtext", labels: "vlabels", label: "vlabel"}
