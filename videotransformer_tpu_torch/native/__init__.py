"""Native (C++) host components: the FFmpeg video decoder, built at first
use with g++ (``videodec.py``)."""
