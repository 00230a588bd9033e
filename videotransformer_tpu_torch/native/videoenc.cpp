// Native video encoder on FFmpeg (companion to videodec.cpp).
//
// The port's copy of the JAX package's native/videoenc.cpp: the same ABI,
// encoder, options and frame timing, so both write the same bytes for the
// same frames. It synthesises the bundled demo clips
// (tools/make_demo_assets.py) and can write visualisations as video.
//
// Uses the built-in MPEG-4 Part 2 encoder (always compiled into libavcodec,
// no external x264 dependency), yuv420p, one pass. Exposed through a C ABI
// and bound from Python via ctypes (no pybind11), like the decoder.
//
// Build: g++ -O2 -shared -fPIC videoenc.cpp -lavformat -lavcodec -lavutil
//        -lswscale -o libvideoenc.so   (see videoenc.py)

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstring>

namespace {

struct Enc {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  AVStream* stream = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;

  ~Enc() {
    if (codec) avcodec_free_context(&codec);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (sws) sws_freeContext(sws);
    if (fmt) {
      if (fmt->pb) avio_closep(&fmt->pb);
      avformat_free_context(fmt);
    }
  }
};

int drain(Enc& e, bool flush) {
  int ret = avcodec_send_frame(e.codec, flush ? nullptr : e.frame);
  if (ret < 0) return ret;
  for (;;) {
    ret = avcodec_receive_packet(e.codec, e.pkt);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
    if (ret < 0) return ret;
    // the mpeg4 encoder leaves duration 0; the mp4 muxer then records a
    // zero-duration final sample, which demuxers skip (losing the last frame)
    if (e.pkt->duration == 0) e.pkt->duration = 1;
    av_packet_rescale_ts(e.pkt, e.codec->time_base, e.stream->time_base);
    e.pkt->stream_index = e.stream->index;
    ret = av_interleaved_write_frame(e.fmt, e.pkt);
    if (ret < 0) return ret;
  }
}

}  // namespace

extern "C" {

// Encode t RGB24 frames (t, h, w, 3, C-contiguous) to `path` at `fps`.
// Returns 0 on success, a negative libav error code otherwise.
int venc_write(const char* path, const uint8_t* rgb, int t, int h, int w,
               int fps) {
  Enc e;
  if (avformat_alloc_output_context2(&e.fmt, nullptr, nullptr, path) < 0 ||
      !e.fmt)
    return -1;

  const AVCodec* enc = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!enc) return -2;
  e.stream = avformat_new_stream(e.fmt, nullptr);
  e.codec = avcodec_alloc_context3(enc);
  if (!e.stream || !e.codec) return -3;

  e.codec->width = w;
  e.codec->height = h;
  e.codec->time_base = AVRational{1, fps};
  e.codec->framerate = AVRational{fps, 1};
  e.codec->pix_fmt = AV_PIX_FMT_YUV420P;
  e.codec->gop_size = 12;
  e.codec->bit_rate = int64_t(w) * h * fps / 2;  // generous for synth content
  if (e.fmt->oformat->flags & AVFMT_GLOBALHEADER)
    e.codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

  int ret = avcodec_open2(e.codec, enc, nullptr);
  if (ret < 0) return ret;
  avcodec_parameters_from_context(e.stream->codecpar, e.codec);
  e.stream->time_base = e.codec->time_base;

  if (!(e.fmt->oformat->flags & AVFMT_NOFILE)) {
    ret = avio_open(&e.fmt->pb, path, AVIO_FLAG_WRITE);
    if (ret < 0) return ret;
  }
  ret = avformat_write_header(e.fmt, nullptr);
  if (ret < 0) return ret;

  e.frame = av_frame_alloc();
  e.pkt = av_packet_alloc();
  if (!e.frame || !e.pkt) return -4;
  e.frame->format = AV_PIX_FMT_YUV420P;
  e.frame->width = w;
  e.frame->height = h;
  if (av_frame_get_buffer(e.frame, 0) < 0) return -5;

  e.sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                         SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!e.sws) return -6;

  const int src_stride = w * 3;
  for (int i = 0; i < t; ++i) {
    if (av_frame_make_writable(e.frame) < 0) return -7;
    const uint8_t* src[1] = {rgb + size_t(i) * h * src_stride};
    const int strides[1] = {src_stride};
    sws_scale(e.sws, src, strides, 0, h, e.frame->data, e.frame->linesize);
    e.frame->pts = i;
    ret = drain(e, false);
    if (ret < 0) return ret;
  }
  ret = drain(e, true);  // flush
  if (ret < 0) return ret;
  return av_write_trailer(e.fmt);
}

}  // extern "C"
