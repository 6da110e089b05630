"""The default configuration tree (the port's copy of
``fact_clip_tpu/configs/default.py``).

The same sections, keys and values, so that the repository's YAML recipes
and ``--set k v`` overrides merge unchanged.  The ``TPU`` section keeps the
JAX package's knobs under their names: the port reads ``pallas``,
``pallas_attn``, ``pallas_sa``, ``quantize_infer``, ``matcher``,
``compute_dtype``, the bucket and segment caps, ``prefetch``,
``cache_features``, ``save_opt_state`` and ``checkpoint_backend``, and
refuses the settings it has no path for (engine/train_loop.py).
"""

from .node import CfgNode as CN

_C = CN()

# auxiliary setting
_C.aux = CN()
_C.aux.gpu = 1  # kept for CLI compatibility; ignored
_C.aux.mark = ""  # for adding additional note
_C.aux.runid = 0  # the X-th run of this configuration
_C.aux.debug = False
_C.aux.wandb_project = "FACT"
_C.aux.wandb_user = ""
_C.aux.wandb_offline = False
_C.aux.resume = "max"  # "", ckpt_path, "max" (resume latest ckpt of the experiment)
_C.aux.eval_every = 1000
_C.aux.print_every = 200
_C.aux.seed = 1  # RNG seed for params/dropout (reference seeds only in debug mode)

# dataset
_C.dataset = "breakfast"
_C.split = "split1"
_C.sr = 1  # temporal down-sample rate
_C.eval_bg = False  # if including background frame in evaluation

# dataset-specific paths (optional, used by HAViD and other datasets)
_C.feature_path = None
_C.groundTruth_path = None
_C.split_path = None
_C.map_fname = None
_C.feature_transpose = False
_C.bg_class = None
_C.average_transcript_len = 0.0

# zero-shot / holdout training
_C.holdout_mode = False  # enable holdout training mode
_C.holdout_classes = []  # list of class indices to hold out during training

# model version selection
_C.use_clip = False  # use FACT_CLIP (open-vocabulary) instead of vanilla FACT

# training
_C.batch_size = 4
_C.optimizer = "SGD"
_C.epoch = 2
_C.lr = 0.1
_C.lr_decay = -1
_C.momentum = 0.009
_C.weight_decay = 0.000
_C.clip_grad_norm = 10.0

#########################
# model
_C.FACT = FACT = CN()
FACT.ntoken = 30
FACT.block = "iuUU"  # i - input block; u - update block; U - update with temporal down/up-sample
FACT.trans = False  # if transcript is available during training + testing
FACT.fpos = True
FACT.cmr = 0.3  # channel masking rate
FACT.mwt = 0.1  # weight for merging predictions from action/frame branch

# input block
_C.Bi = Bi = CN()
Bi.hid_dim = 512
Bi.dropout = 0.5

Bi.a = "sca"
Bi.a_nhead = 8
Bi.a_ffdim = 2048
Bi.a_layers = 6
Bi.a_dim = 512

Bi.f = "cnn"
Bi.f_layers = 10
Bi.f_ln = True
Bi.f_dim = 512
Bi.f_ngp = 4

# update block
_C.Bu = Bu = CN()
Bu.hid_dim = None
Bu.dropout = None

Bu.a = "sa"
Bu.a_nhead = None
Bu.a_ffdim = None
Bu.a_layers = 1
Bu.a_dim = None

Bu.f = None
Bu.f_layers = 5
Bu.f_ln = None
Bu.f_dim = None
Bu.f_ngp = None

# update block with temporal downsample and upsample
_C.BU = BU = CN()
BU.hid_dim = None
BU.dropout = None

BU.a = "sa"
BU.a_nhead = None
BU.a_ffdim = None
BU.a_layers = 1
BU.a_dim = None

BU.f = None
BU.f_layers = 5
BU.f_ln = None
BU.f_dim = None
BU.f_ngp = None

BU.s_layers = 1

#########################
# Loss
_C.Loss = Loss = CN()
Loss.pc = 1.0  # match weight for prob
Loss.a2fc = 1.0  # match weight for a2f_attn overlap
Loss.match = "o2o"  # one-to-one(o2o) or one-to-many(o2m) or sequential(seq)
Loss.bgw = 1.0  # weight for background class
Loss.nullw = -1.0  # weight for null class in action token; -1 -> auto-compute
Loss.sw = 0.0  # weight for smoothing loss
# reproduce the reference's segment-weight permutation in cross-attention
# losses (loss.py:218-219) exactly — only differs when bgw != 1 (egoprocel)
Loss.ref_weight_order = False

#########################
# temporal masking
_C.TM = TM = CN()
TM.use = False
TM.t = 30
TM.p = 0.05
TM.m = 5
TM.inplace = True

#########################
# CLIP configuration for open-vocabulary model
_C.CLIP = CLIP = CN()
CLIP.model_name = "openai/clip-vit-base-patch32"
CLIP.text_trainable = True
CLIP.temp = 0.07  # temperature for InfoNCE loss
CLIP.precompute_text = True  # pre-compute text embeddings
CLIP.use_prompt = True  # use prompt engineering
CLIP.text_emb_path = None  # path to save/load pre-computed embeddings
CLIP.contrastive_weight = 0.5  # weight for contrastive loss
CLIP.fact_loss_weight = 0.5  # weight for FACT loss

# Visual projection settings
CLIP.projection_hidden_dim = 512  # hidden layer in projection
CLIP.projection_dropout = 0.1  # dropout in projection

#########################
# execution knobs (the JAX package's TPU section, under its names)
_C.TPU = TPU = CN()
TPU.bucket_multiple = 128  # pad video lengths up to a multiple of this
TPU.bucket_growth = 1.26  # geometric growth between length buckets
TPU.max_gt_segs = -1  # cap on ground-truth segments; -1 -> scan dataset
TPU.max_pred_segs = -1  # cap on TDU predicted segments; -1 -> auto from max_gt_segs
TPU.compute_dtype = "float32"  # "float32" | "bfloat16" (FACT's f: m towers, dropout 0 to train)
TPU.feature_dtype = ""  # input-feature feed dtype; "" -> follow compute_dtype
TPU.matcher = "auto"  # "auto" = "host" (scipy) | "auction" (on the device, ops/assignment.py)
TPU.auction_phases = 1  # >1: the auction's epsilon scaling
# the mesh's knobs: read only on paths that raise in the port (shards > 1)
TPU.data_axis = "data"
TPU.seq_axis = "seq"
TPU.num_data_shards = -1  # -1 -> all visible devices; the port trains on one
TPU.num_seq_shards = 1
TPU.eval_seq_min_T = 0
TPU.num_slice_shards = 1
TPU.pallas = True  # the hand-written CUDA kernels (False: the plain PyTorch path)
# "int8": evaluation runs the towers and projections on int8 kernels (K8)
TPU.quantize_infer = ""
TPU.pallas_attn = True  # the SCA cross-attention kernel (needs TPU.pallas)
TPU.pallas_sa = True  # the SA / FFN sublayer kernels (needs TPU.pallas)
TPU.prefetch = 2  # host batch prefetch depth
TPU.cache_features = True  # false -> read features per batch
TPU.profile_dir = ""  # non-empty asks for a profiler trace (not ported)
TPU.profile_start = 10
TPU.profile_stop = 15
TPU.checkpoint_backend = "msgpack"  # one weights file per checkpoint ("orbax" is not ported)
# also write the optimizer's state and step count in a sidecar
# state.iter-<N>.state, so that a resume continues the optimizer
TPU.save_opt_state = True
TPU.flat_opt_state = True  # JAX's optimizer layout; the port's has one, with the same result
TPU.matmul_precision = ""


def get_cfg_defaults() -> CN:
    return _C.clone()
