"""Buffer-stash elements: originalbuffersave / originalbufferrestore.

Parity target: generic/originalbuffer (834 LoC): stash the pristine buffer in
a meta before lossy processing so analytics downstream can recover it
(SURVEY.md §2.2).
"""
from __future__ import annotations


from ...core import BaseTransform, Buffer, Meta, TransformMode, register


class OriginalBufferMeta(Meta):
    api = "original-buffer"

    def __init__(self, buffer: Buffer):
        self.buffer = buffer

    def __repr__(self):
        return f"OriginalBufferMeta({self.buffer!r})"


@register
class OriginalBufferSave(BaseTransform):
    ELEMENT_NAME = "originalbuffersave"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Stores a reference to the pristine buffer in a meta"
    MODE = TransformMode.ALWAYS_IN_PLACE

    def transform_ip(self, buf: Buffer) -> Buffer:
        if buf.get_meta(OriginalBufferMeta) is None:
            pristine = Buffer(buf.data)
            pristine.copy_metadata_from(buf)
            pristine.metas = [m for m in pristine.metas if not isinstance(m, OriginalBufferMeta)]
            buf.add_meta(OriginalBufferMeta(pristine))
        return buf


@register
class OriginalBufferRestore(BaseTransform):
    ELEMENT_NAME = "originalbufferrestore"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Restores the pristine buffer stored by originalbuffersave"
    MODE = TransformMode.NEVER_IN_PLACE

    def transform(self, inbuf: Buffer) -> Buffer:
        meta = inbuf.get_meta(OriginalBufferMeta)
        if meta is None:
            return inbuf
        out = Buffer(meta.buffer.data)
        out.copy_metadata_from(inbuf)
        # keep analytics metas gathered since the save, drop the stash itself
        out.metas = [m for m in out.metas if not isinstance(m, OriginalBufferMeta)]
        return out


__all__ = ["OriginalBufferSave", "OriginalBufferRestore", "OriginalBufferMeta"]
