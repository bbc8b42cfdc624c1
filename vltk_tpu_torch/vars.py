"""Entry keys and packaged data paths of the port.

A copy of ``vltk_tpu/vars.py`` (the port imports nothing of the JAX
package): the column and batch keys that adapters, processors, loaders,
predictors and experiments read and write, the split aliases, the
vision / vision-language key renames, and the paths of the port's own
copies of the BERT vocabulary and the VQA answer tables.

Boxes at the data layer are ``(x, y, w, h)`` in absolute pixels; a model
that wants ``xyxy`` converts explicitly.
"""

from __future__ import annotations

import os

BASEPATH = os.path.abspath(os.path.dirname(__file__))
LIBDATA = os.path.join(BASEPATH, "libdata")
VOCABPATH = os.path.join(LIBDATA, "vocab.txt")
ANNOTATION_DIR = "annotations"

# delimiter of composite ids
delim = "^"

# ids and bookkeeping
imgid = "imgid"
qid = "qid"
split = "split"
filepath = "filepath"

# language
text = "text"
input_ids = "input_ids"
type_ids = "type_ids"
text_attention_mask = "text_attention_mask"
span = "span"
tokenmap = "tokenmap"
tokenlabels = "tokenlabels"

# vision
img = "image"
size = "size"
rawsize = "rawsize"
padsize = "padsize"
scale = "wh_scale"
boxes = "boxes"
box = "box"
boxtensor = "boxtensor"
tokenbox = "tokenbox"
tokenboxes = "tokenboxes"
polygons = "poly"
RLE = "RLE"
segmentations = "segmentations"
segmentation = "segmentation"
area = "area"
features = "features"
n_objects = "n_objects"
objects = "objects"

# supervision
labels = "labels"
label = "label"
scores = "scores"
score = "score"

# validity masks of padded fixed-shape tensors
boxes_mask = "boxes_mask"
visual_attention_mask = "visual_attention_mask"

SPLITALIASES = {"test", "dev", "eval", "val", "validation", "evaluation", "train"}

# text-side keys of a vision dataset, renamed with a "v" prefix when it is
# joined with a vision-language dataset by image id
VLOVERLAP = {text: "vtext", labels: "vlabels", label: "vlabel", scores: "vscores", score: "vscore"}

# dataset kinds
VLDATA = 0
VDATA = 1
LDATA = 2
