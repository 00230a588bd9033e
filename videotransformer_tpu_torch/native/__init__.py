"""Native (C++) host components, built at first use with g++: the FFmpeg
video decoder (``videodec.py``) and encoder (``videoenc.py``)."""
