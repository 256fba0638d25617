from . import cea708, elements, files, overlay, st2038, transcriberbin, translationbin  # noqa: F401
