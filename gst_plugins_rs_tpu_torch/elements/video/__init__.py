"""Video effect elements of the port: colorlut, hsvfilter, hsvdetector."""
