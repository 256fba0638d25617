"""Video elements of the port: colorlut, hsvfilter, hsvdetector, videoscale,
videoconvertscale, skiacompositor, roundedcorners, colordetect, videocompare."""
