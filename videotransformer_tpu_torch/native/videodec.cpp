// Native random-access video decoder (decord-equivalent) on FFmpeg.
//
// Role: host-CPU decode stage of the input pipeline (the original PyTorch
// repo decodes with decord's C++ VideoReader; this is our own implementation,
// exposed through a C ABI and bound from Python via ctypes, no pybind11).
// The port's copy of the JAX package's native/videodec.cpp: the same ABI,
// seek and decode logic and swscale flags, so both decode the same bytes.
//
// Design:
//  - open(): demux headers, find the best video stream, open the codec with
//    a caller-chosen thread count.
//  - get_batch(indices): random access by frame number. For each requested
//    index we either continue decoding forward (small skips — the common case
//    for sorted linspace sampling) or av_seek_frame to the nearest keyframe
//    before the target and decode forward. Frames convert to RGB24 via
//    swscale into the caller's buffer (numpy-owned, zero extra copies).
//  - num_frames(): container metadata (nb_frames) when present, otherwise
//    duration * fps, otherwise a full packet count scan.
//
// Build: g++ -O2 -shared -fPIC videodec.cpp -lavformat -lavcodec -lavutil
//        -lswscale -o libvideodec.so   (videodec.py runs it at first use,
//        into videotransformer_tpu_torch/build/)

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
#include <libavutil/opt.h>
}

#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct VideoDec {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVFrame* last = nullptr;  // ref to the most recent decoded frame: survives
                            // the EOF receive (which unrefs `frame`), so the
                            // reuse-last-frame path always has valid planes
  int64_t last_idx = -1;    // frame index held by `last` (-1: none yet)
  AVPacket* pkt = nullptr;
  int stream_idx = -1;
  int64_t num_frames = 0;
  double fps = 0.0;
  int width = 0;   // decoded width
  int height = 0;  // decoded height
  int out_w = 0;   // output (post-resize) width
  int out_h = 0;   // output (post-resize) height
  // decode cursor: index of the next frame that would be produced
  int64_t next_frame = 0;
  bool at_eof = false;
  char err[256] = {0};
};

void set_err(VideoDec* v, const char* msg) {
  std::strncpy(v->err, msg, sizeof(v->err) - 1);
}

double stream_fps(AVStream* st) {
  AVRational r = st->avg_frame_rate;
  if (r.num == 0 || r.den == 0) r = st->r_frame_rate;
  if (r.num == 0 || r.den == 0) return 25.0;
  return av_q2d(r);
}

int64_t count_frames_by_scan(VideoDec* v) {
  int64_t count = 0;
  AVPacket* pkt = av_packet_alloc();
  while (av_read_frame(v->fmt, pkt) >= 0) {
    if (pkt->stream_index == v->stream_idx) count++;
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  av_seek_frame(v->fmt, v->stream_idx, 0, AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(v->codec);
  v->next_frame = 0;
  v->last_idx = -1;
  v->at_eof = false;
  return count;
}

// Decode the next video frame into v->frame. Returns 1 on success, 0 on EOF,
// <0 on error.
int decode_next(VideoDec* v) {
  while (true) {
    int ret = avcodec_receive_frame(v->codec, v->frame);
    if (ret == 0) {
      av_frame_unref(v->last);
      av_frame_ref(v->last, v->frame);
      return 1;
    }
    if (ret != AVERROR(EAGAIN) && ret != AVERROR_EOF) return ret;
    if (ret == AVERROR_EOF) return 0;
    // need more packets
    while (true) {
      ret = av_read_frame(v->fmt, v->pkt);
      if (ret < 0) {
        // flush
        avcodec_send_packet(v->codec, nullptr);
        break;
      }
      if (v->pkt->stream_index == v->stream_idx) {
        ret = avcodec_send_packet(v->codec, v->pkt);
        av_packet_unref(v->pkt);
        if (ret < 0 && ret != AVERROR(EAGAIN)) return ret;
        break;
      }
      av_packet_unref(v->pkt);
    }
  }
}

// Seek so that the decode cursor lands at or before `target`.
int seek_to(VideoDec* v, int64_t target) {
  AVStream* st = v->fmt->streams[v->stream_idx];
  double fps = v->fps > 0 ? v->fps : 25.0;
  int64_t ts = av_rescale_q(
      (int64_t)(target / fps * AV_TIME_BASE), AV_TIME_BASE_Q, st->time_base);
  if (av_seek_frame(v->fmt, v->stream_idx, ts, AVSEEK_FLAG_BACKWARD) < 0)
    return -1;
  avcodec_flush_buffers(v->codec);
  v->at_eof = false;
  // decode one frame to learn where we landed
  int ret = decode_next(v);
  if (ret <= 0) return -1;
  AVRational tb = st->time_base;
  int64_t pts = v->frame->best_effort_timestamp;
  int64_t start = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
  int64_t landed =
      (int64_t)((pts - start) * av_q2d(tb) * fps + 0.5);
  v->next_frame = landed + 1;
  v->last_idx = landed;
  return 0;  // current frame in v->last is index `landed`
}

}  // namespace

extern "C" {

// target_short_edge > 0: scale so the short edge equals it (preserving
// aspect, floor like torchvision Resize) during the RGB conversion — the
// resize rides the mandatory swscale pass for free.
void* vd_open(const char* path, int num_threads, int target_short_edge) {
  av_log_set_level(AV_LOG_ERROR);
  VideoDec* v = new (std::nothrow) VideoDec();
  if (!v) return nullptr;
  if (avformat_open_input(&v->fmt, path, nullptr, nullptr) < 0) {
    delete v;
    return nullptr;
  }
  if (avformat_find_stream_info(v->fmt, nullptr) < 0) {
    avformat_close_input(&v->fmt);
    delete v;
    return nullptr;
  }
  const AVCodec* dec = nullptr;
  v->stream_idx =
      av_find_best_stream(v->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (v->stream_idx < 0 || !dec) {
    avformat_close_input(&v->fmt);
    delete v;
    return nullptr;
  }
  AVStream* st = v->fmt->streams[v->stream_idx];
  v->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(v->codec, st->codecpar);
  v->codec->thread_count = num_threads > 0 ? num_threads : 1;
  if (avcodec_open2(v->codec, dec, nullptr) < 0) {
    avcodec_free_context(&v->codec);
    avformat_close_input(&v->fmt);
    delete v;
    return nullptr;
  }
  v->frame = av_frame_alloc();
  v->last = av_frame_alloc();
  v->pkt = av_packet_alloc();
  v->fps = stream_fps(st);
  v->width = v->codec->width;
  v->height = v->codec->height;
  v->out_w = v->width;
  v->out_h = v->height;
  if (target_short_edge > 0) {
    if (v->height <= v->width) {
      v->out_h = target_short_edge;
      v->out_w = (int)((int64_t)target_short_edge * v->width / v->height);
    } else {
      v->out_w = target_short_edge;
      v->out_h = (int)((int64_t)target_short_edge * v->height / v->width);
    }
  }
  v->num_frames = st->nb_frames;
  if (v->num_frames <= 0 && st->duration != AV_NOPTS_VALUE) {
    v->num_frames =
        (int64_t)(st->duration * av_q2d(st->time_base) * v->fps + 0.5);
  }
  if (v->num_frames <= 0) v->num_frames = count_frames_by_scan(v);
  return v;
}

int64_t vd_num_frames(void* h) { return ((VideoDec*)h)->num_frames; }
double vd_fps(void* h) { return ((VideoDec*)h)->fps; }
int vd_width(void* h) { return ((VideoDec*)h)->out_w; }
int vd_height(void* h) { return ((VideoDec*)h)->out_h; }
const char* vd_error(void* h) { return ((VideoDec*)h)->err; }

// out: caller buffer of n * height * width * 3 bytes (RGB24, frame-major,
// in the order of `indices`). Contract: `indices` must be ascending (the
// Python wrapper sorts and restores order); repeats are allowed.
int vd_get_batch(void* h, const int64_t* indices, int n, uint8_t* out) {
  VideoDec* v = (VideoDec*)h;
  const int W = v->out_w, H = v->out_h;
  if (!v->sws) {
    // dithering advances internal state per call, making repeated conversions
    // of the same frame differ by +-1 LSB; disable it for determinism
    v->sws = sws_alloc_context();
    if (v->sws) {
      av_opt_set_int(v->sws, "srcw", v->width, 0);
      av_opt_set_int(v->sws, "srch", v->height, 0);
      av_opt_set_int(v->sws, "src_format", v->codec->pix_fmt, 0);
      av_opt_set_int(v->sws, "dstw", W, 0);
      av_opt_set_int(v->sws, "dsth", H, 0);
      av_opt_set_int(v->sws, "dst_format", AV_PIX_FMT_RGB24, 0);
      av_opt_set_int(v->sws, "sws_flags", SWS_BILINEAR | SWS_ACCURATE_RND, 0);
      av_opt_set(v->sws, "sws_dither", "none", 0);
      if (sws_init_context(v->sws, nullptr, nullptr) < 0) {
        sws_freeContext(v->sws);
        v->sws = nullptr;
      }
    }
    if (!v->sws) {
      set_err(v, "swscale init failed");
      return -1;
    }
  }

  for (int i = 0; i < n; i++) {
    int64_t target = indices[i];
    if (target < 0) target = 0;
    if (target >= v->num_frames) target = v->num_frames - 1;

    bool have_frame = v->last_idx == target;
    if (!have_frame && (target < v->next_frame || target > v->next_frame + 256)) {
      if (seek_to(v, target) < 0) {
        set_err(v, "seek failed");
        return -2;
      }
      // seek_to decoded frame (next_frame - 1) into `last`
      if (v->next_frame - 1 == target) {
        have_frame = true;
      } else if (v->next_frame - 1 > target) {
        // landed past the target (coarse timestamps): rewind fully
        av_seek_frame(v->fmt, v->stream_idx, 0, AVSEEK_FLAG_BACKWARD);
        avcodec_flush_buffers(v->codec);
        v->next_frame = 0;
      }
    }
    while (!have_frame) {
      int ret = decode_next(v);
      if (ret < 0) {
        set_err(v, "decode error");
        return -3;
      }
      if (ret == 0) break;  // EOF: reuse last decoded frame
      int64_t cur = v->next_frame;
      v->next_frame = cur + 1;
      v->last_idx = cur;
      if (cur >= target) have_frame = true;
    }
    if (v->last_idx < 0) {
      set_err(v, "no frame decoded");
      return -4;
    }

    uint8_t* dst[1] = {out + (int64_t)i * H * W * 3};
    int dst_stride[1] = {W * 3};
    sws_scale(v->sws, v->last->data, v->last->linesize, 0, v->height, dst,
              dst_stride);
  }
  return 0;
}

void vd_close(void* h) {
  VideoDec* v = (VideoDec*)h;
  if (v->sws) sws_freeContext(v->sws);
  if (v->frame) av_frame_free(&v->frame);
  if (v->last) av_frame_free(&v->last);
  if (v->pkt) av_packet_free(&v->pkt);
  if (v->codec) avcodec_free_context(&v->codec);
  if (v->fmt) avformat_close_input(&v->fmt);
  delete v;
}

}  // extern "C"
