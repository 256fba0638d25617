"""Element library of the port.  Importing this package registers the
factories ported so far: the core plumbing (sources, sinks, capsfilter,
identity, queue, tee, audioconvert, audioresample, videoconvert; volume,
videoflip, videocrop, videorate, audiorate), the YOLOX
detection slice, the per-pixel video effects (colorlut, hsvfilter,
hsvdetector), the scalers, compositor and frame analysis (videoscale,
videoconvertscale, skiacompositor, roundedcorners, colordetect,
videocompare), the EBU R-128 audio path (audioloudnorm, ebur128level,
rsaudioecho), the RNNoise denoiser (audiornnoise), the spatial renderers
(hrtfrender, sofalizer), agingradio, audiomixer, the Demucs source
separator (demucs), speech transcription (whispertranscriber), the palm
detection decoder (handdetectiontensordec), the stream bank
(loudnormbank), and the host-only generic, switching and text families
(file, inter, compression, brotli and sodium elements, gopbuffer,
debugseimetainserter, originalbuffer*, the misc inventory, the remaining
ts-* elements, decodebin, togglerecord, fallbackswitch, livesync,
fallbacksrc, regex, textwrap, textaccumulate, jsongst*), the muxers
(isofmp4mux, cmafmux, dashmp4mux, onviffmp4mux, isomp4mux, onvifmp4mux,
mpegtsmux, rsflvdemux) and the closed-caption family (the CEA-608/708 and
ST-2038 elements, the SCC/MCC parsers and encoders, cea608overlay,
transcriberbin, translationbin)."""
from . import sinks, sources  # noqa: F401
from .analytics import combiner, handdetection, meta, yoloxinference, yoloxtensordec  # noqa: F401
from .audiofx import (  # noqa: F401
    agingradio,
    audioecho,
    audioloudnorm,
    audiomixer,
    audiornnoise,
    demucs,
    ebur128level,
    hrtfrender,
    loudnormbank,
    sofalizer,
    whisper,
)
from .cc import elements as cc_elements  # noqa: F401  (registers the whole family)
from .generic import (  # noqa: F401
    basic,
    buffers,
    convert,
    corefx,
    debugsei,
    decodebin,
    gopbuffer,
    io,
    misc,
    sodium,
    threadshare_extra,
)
from .mux import flv, isobmff, tsmux  # noqa: F401
from .text import elements as text_elements  # noqa: F401
from .utilsfx import fallbacksrc, switching, togglerecord  # noqa: F401
from .video import (  # noqa: F401
    colordetect,
    colorlut,
    compositor,
    hsv,
    roundedcorners,
    videocompare,
    videoscale,
)
