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
detection decoder (handdetectiontensordec) and the stream bank
(loudnormbank)."""
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
from .generic import basic, convert, corefx  # noqa: F401
from .video import (  # noqa: F401
    colordetect,
    colorlut,
    compositor,
    hsv,
    roundedcorners,
    videocompare,
    videoscale,
)
