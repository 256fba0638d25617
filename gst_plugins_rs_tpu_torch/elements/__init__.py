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
mpegtsmux, rsflvdemux), the closed-caption family (the CEA-608/708 and
ST-2038 elements, the SCC/MCC parsers and encoders, cea608overlay,
transcriberbin, translationbin), the ONVIF metadata converters
(relationmeta2onvifmeta, onvifmeta2relationmeta) and the network elements
of elements/net (G.711 codecs, RTP payloaders, the onvifmetadata family,
rtpsend, rtprecv, ts-jitterbuffer, RaptorQ FEC, the UDP elements, the RTSP,
HTTP, HLS and DASH elements, and the WebRTC family: webrtcsink, webrtcsrc,
webrtcsend, webrtcrecv, whipsink, whepsrc, whipclientsink, whepclientsrc,
whipserversrc, whepserversink, janusvrwebrtcsink, janusvrwebrtcsrc,
awskvswebrtcsink, uepswebrtcsink), and the
codec and image families (claxondec, lewtondec, dav1ddec, ffv1dec, rav1enc,
rspngenc, gifenc, gifdec, rswebpdec, imagersdec, imagersoverlay, cdgparse,
cdgdec)."""
from . import sinks, sources  # noqa: F401
from .analytics import (  # noqa: F401
    combiner,
    handdetection,
    meta,
    onvif as analytics_onvif,
    yoloxinference,
    yoloxtensordec,
)
from .audiofx import (  # noqa: F401
    agingradio,
    audioecho,
    audioloudnorm,
    audiomixer,
    audiornnoise,
    claxondec,
    demucs,
    ebur128level,
    hrtfrender,
    lewtondec,
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
from .image import cdg, codecs as image_codecs, overlay as image_overlay  # noqa: F401
from .mux import flv, isobmff, tsmux  # noqa: F401
from .net import codecs as net_codecs, onvif, rtpbin2, rtppay  # noqa: F401
from .text import elements as text_elements  # noqa: F401
from .utilsfx import fallbacksrc, switching, togglerecord  # noqa: F401
from .video import (  # noqa: F401
    avcodecs,
    colordetect,
    colorlut,
    compositor,
    hsv,
    roundedcorners,
    videocompare,
    videoscale,
)
