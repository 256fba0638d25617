"""Text elements of the port: regex, textwrap, textaccumulate, jsongstenc
and jsongstparse."""
