"""yoloxinference: YOLOX object detection attaching tensors to video buffers.

Parity target: analytics/burn/src/yoloxinference/imp.rs (677 LoC): in-place
video element, caps RGB with width/height multiples of 32 (imp.rs:237-253);
attaches a `yolox-out` tensor/strided TensorMeta dims [1, N, 5+classes] f32
row-major (imp.rs:415-472).  Model zoo nano..x via width/depth multipliers;
`weights-path` loads a PyTorch state_dict with the reference's key remapping.
Registered as both `yoloxinference` and the reference's `burn-yoloxinference`.

The forward pass runs on the device `gst_plugins_rs_tpu_torch.set_device`
selects (CUDA unless the CPU was requested); the output tensor stays on the
device in the meta (consumers map it on demand).  On CUDA, engine=fast and
fast-bf16 run dark2's C3 as the fused kernel (ops/yolox_c3.py) wherever it
fits one block's shared memory (all but YOLOX-x in bf16:
`FastEngine.c3_route`); on the CPU they run the per-conv form, as the JAX
element does.

`shard=true` builds a mesh of every visible device at start
(parallel/mesh.py).  shard-mode=data: an analytics-batch window is padded
to a multiple of the mesh, split over the shards, run by one engine per
distinct device (B1 once a shard on CUDA), and the padded rows are
discarded.  shard-mode=tensor: the reference-shaped graph with every conv's
output channels sharded over the mesh (parallel/modelparallel.py), float32,
as the JAX element's tensor mode runs it.  Without
`weights-path`, weights come from flax's default initialisers drawn from a
torch.Generator seeded 0, which cannot reproduce jax.random.PRNGKey(0).
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

from ...core import (
    Buffer,
    Caps,
    IntRange,
    Prop,
    TransformMode,
    VideoFilter,
    register,
    video_caps_template,
)
from ..._device import device, no_tf32, visible_devices
from ...models.yolox import Yolox, init_weights, load_torch_weights
from ...models.yolox_fast import FastEngine
from .meta import Tensor, TensorDataType, TensorDimOrder, TensorMeta

YOLOX_OUT = "yolox-out"


def _caps_32() -> Caps:
    caps = video_caps_template(("RGB",))
    s = caps.structure(0)
    s["width"] = IntRange(32, 2**31 - 32)
    s["height"] = IntRange(32, 2**31 - 32)
    return caps


def _caps_32_or_batch() -> Caps:
    """Raw RGB frames, or analyticscombiner batch buffers (every stream's
    frame in a window runs as ONE batched forward pass; the
    multi-stream path of SURVEY §2.3)."""
    caps = _caps_32()
    from .combiner import BATCH_CAPS

    return Caps(list(caps.structures) + [s.copy() for s in BATCH_CAPS.structures])


class YoloxInference(VideoFilter):
    ELEMENT_NAME = "yoloxinference"
    ELEMENT_CLASS = "Filter/Analyzer/Video"
    ELEMENT_DESCRIPTION = "YOLOX object detection inference, attaches tensor meta"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False
    SINK_CAPS = _caps_32_or_batch()
    SRC_CAPS = _caps_32_or_batch()

    PROPERTIES = [
        Prop("model-type", "tiny", type="enum", choices=["nano", "tiny", "s", "m", "l", "x"],
             mutable="ready"),
        Prop("num-classes", 80, type="uint", minimum=1, mutable="ready"),
        Prop("weights-path", None, type="str", mutable="ready",
             doc="PyTorch .pth checkpoint (official YOLOX state_dict)"),
        Prop("backend-type", "tpu", type="str", mutable="ready",
             doc="Accepted for API parity; inference runs on the device "
                 "gst_plugins_rs_tpu_torch.set_device selects (CUDA by default)"),
        Prop("precision", "f32", type="enum", choices=["f32", "bf16"],
             mutable="ready",
             doc="activation dtype of the engine (bf16 halves activation "
                 "traffic)"),
        Prop("engine", "fast", type="enum",
             choices=["fast", "fast-bf16", "reference"],
             mutable="ready",
             doc="fast = s2d-domain inference engine (models/yolox_fast.py, "
                 "numerically equivalent; on CUDA dark2's C3 runs as the "
                 "fused kernel of ops/yolox_c3.py); fast-bf16 "
                 "additionally runs the dominant stem+dark2 stage in "
                 "bfloat16 activations (detection-level parity gated in "
                 "tests/test_torch_yolox.py); reference = the "
                 "reference-shaped graph (models/yolox.py)"),
        Prop("shard", False, type="bool", mutable="ready",
             doc="shard the batch axis of analytics-batch input over a "
                 "jax.sharding.Mesh of all visible devices (one forward "
                 "pass per combiner window, streams data-parallel over "
                 "the mesh)"),
        Prop("shard-mode", "data", type="enum", choices=["data", "tensor"],
             mutable="ready",
             doc="with shard=true: 'data' = streams/batch data-parallel "
                 "over the mesh; 'tensor' = ONE forward model-parallel — "
                 "every conv's output channels pjit-sharded over the mesh "
                 "(parallel/modelparallel.py; SURVEY §2.3 'shard model "
                 "across TPU mesh with pjit if needed (YOLOX-X)'). Tensor "
                 "mode pays per-layer all-gathers; prefer data mode unless "
                 "single-image latency dominates (PERF_NOTES)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._model: Optional[Yolox] = None
        self._apply = None
        self._device: Optional[torch.device] = None
        self._batch_mode = False
        self._mesh = None
        self._engines = None

    def start(self) -> None:
        self._device = device()
        self._model = Yolox.from_variant(self.get_property("model-type"),
                                         self.get_property("num-classes"))
        self._apply = None  # built at the first frame
        self._engines = None
        self._mesh = None
        if self.get_property("shard"):
            from ...parallel.mesh import Mesh

            axis = "tp" if self.get_property("shard-mode") == "tensor" else "batch"
            self._mesh = Mesh(visible_devices(), (axis,))

    def stop(self) -> None:
        self._model = None
        self._apply = None
        self._engines = None
        self._mesh = None

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        # analytics-batch input: per-stream video info comes from each
        # BatchStreamEntry's caps instead of the element caps
        if incaps.structure(0).name == "multistream/x-analytics-batch":
            self._batch_mode = True
            self.video_info = None
            self.out_video_info = None
            return
        self._batch_mode = False
        super().set_caps(incaps, outcaps)

    def _ensure_model(self) -> None:
        if self._apply is not None:
            return
        model = init_weights(self._model, seed=0)
        path = self.get_property("weights-path")
        if path:
            load_torch_weights(path, model)
        if self._mesh is not None and "tp" in self._mesh.shape:
            # tensor parallelism: conv output channels sharded over the mesh
            from ...parallel.modelparallel import shard_yolox_variables, tp_forward

            self._apply = tp_forward(
                model, shard_yolox_variables(model.state_dict(), self._mesh), self._mesh)
            return
        self._apply = self._build(model, self._device)
        if self._mesh is not None:
            from ...parallel.mesh import canonical
            from ...parallel.streams import per_device

            # data parallelism: one engine per distinct device of the mesh
            home = canonical(self._device)
            self._engines = per_device(
                lambda d: self._apply if d == home else self._build(copy.deepcopy(model), d))

    def _build(self, model: Yolox, dev: torch.device):
        """The forward of the chosen engine, with model's weights on dev."""
        model.to(dev)
        dtype = (torch.bfloat16 if self.get_property("precision") == "bf16"
                 else torch.float32)
        engine = self.get_property("engine")
        if engine in ("fast", "fast-bf16"):
            # BN folding and the s2d kernels are built once, here
            s2d_dtype = torch.bfloat16 if engine == "fast-bf16" else None
            return FastEngine(model, model.state_dict(), dtype=dtype, s2d_dtype=s2d_dtype,
                              fuse_c3=dev.type == "cuda", device=dev)
        if dtype == torch.bfloat16:
            model.to(torch.bfloat16)

            def run(img):
                with torch.no_grad():
                    return model(img.to(torch.bfloat16)).to(torch.float32)

            return run

        def run(img):
            with torch.no_grad(), no_tf32():
                return model(img)

        return run

    def _forward_batch(self, batch):
        """One forward over a window's frames [N, H, W, 3]; data-parallel
        over the mesh in shard-mode=data (the batch padded to a multiple of
        the mesh, the padded rows discarded)."""
        if self._engines is None:
            return self._apply(batch)
        from ...parallel.mesh import gather, shard

        n, S = batch.shape[0], self._mesh.size
        if n % S:
            batch = torch.cat([batch, batch.new_zeros((S - n % S,) + tuple(batch.shape[1:]))])
        outs = [self._engines(p.device)(p) for p in shard(batch, self._mesh)]
        return gather(outs, device=batch.device)[:n]

    def _transform_batch(self, buf: Buffer) -> Buffer:
        """analytics-batch input: ONE forward pass over every frame in the
        window ([N,H,W,3] stacked on the device); per-frame [1,boxes,85]
        TensorMeta slices are attached to each inner stream buffer."""
        from .combiner import BatchMeta
        from ...core.video import VideoInfo

        meta = buf.get_meta(BatchMeta)
        if meta is None or not meta.streams:
            return buf
        frames, owners = [], []
        h = w = None
        for entry in meta.streams:
            vi = VideoInfo.from_caps(entry.caps) if entry.caps else None
            for inner in entry.buffers:
                if inner.data is None:
                    continue
                arr = torch.as_tensor(inner.data, device=self._device)
                if arr.ndim == 2:  # flat bytes: need caps dims
                    assert vi is not None, "batch stream without video caps"
                    arr = arr.reshape(vi.height, vi.width, 3)
                if h is None:
                    h, w = int(arr.shape[0]), int(arr.shape[1])
                elif (int(arr.shape[0]), int(arr.shape[1])) != (h, w):
                    raise ValueError(
                        "analytics-batch streams must share dimensions for "
                        f"batched inference: {(h, w)} vs {tuple(arr.shape[:2])}")
                frames.append(arr)
                owners.append(inner)
        if not frames:
            return buf
        self._ensure_model()
        out = self._forward_batch(torch.stack(frames))  # [N, H, W, 3] u8
        boxes, cols = int(out.shape[1]), int(out.shape[2])
        for i, inner in enumerate(owners):
            inner.add_meta(TensorMeta([
                Tensor(YOLOX_OUT, TensorDataType.FLOAT32, (1, boxes, cols),
                       TensorDimOrder.ROW_MAJOR, out[i:i + 1])]))
        return buf

    def transform_ip(self, buf: Buffer) -> Buffer:
        if self._batch_mode:
            return self._transform_batch(buf)
        assert self.video_info is not None
        self._ensure_model()
        # the frame stays u8 to the model, which casts after the stem's
        # transpose (u8 moves 4x fewer bytes than f32)
        img = torch.as_tensor(buf.data, device=self._device)[None]  # [1, H, W, 3]
        out = self._apply(img)  # [1, N, 5+classes]
        n, cols = int(out.shape[1]), int(out.shape[2])
        buf.add_meta(TensorMeta([
            Tensor(YOLOX_OUT, TensorDataType.FLOAT32, (1, n, cols),
                   TensorDimOrder.ROW_MAJOR, out)]))
        return buf


# reference-compatible factory name
@register
class BurnYoloxInference(YoloxInference):
    ELEMENT_NAME = "burn-yoloxinference"


register(YoloxInference)

__all__ = ["YoloxInference", "BurnYoloxInference", "YOLOX_OUT"]
