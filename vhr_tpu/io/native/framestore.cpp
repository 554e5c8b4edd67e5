// framestore: threaded host-side video decode + staging service.
//
// The accelerator does not decode H.264 here; the host must deliver
// contiguous (T, H, Wpad, 3) uint8 chunks fast enough to keep it busy (the
// reference decodes synchronously inside its compute loop,
// rppg_VIDEO.py:356).  This service decodes on a background thread into a
// bounded ring of pre-allocated staging buffers, so decode overlaps with
// device compute, and optionally row-pads frames to a 128-byte multiple.
//
// C ABI (consumed from Python via ctypes — no pybind11 in this image):
//   vhr_open(path, chunk_frames, pad_row_to, n_decoders, format)
//       -> handle (>0) or 0; format 0 = interleaved BGR rows (row-padded),
//          format 1 = planar YUV I420 (1.5 B/px, frame-stride padded) — the
//          low-bandwidth staging mode: I420 carries the same video in
//          half the bytes of BGR; the device
//          reconstructs BGR bit-exactly vs OpenCV (ops/color.py::i420_to_bgr)
//   vhr_meta(handle, out[5])                  -> width,height,fps,count,
//                                                padded_width | frame_stride
//   vhr_next_chunk(handle, buf, buf_bytes)    -> frames filled (0 = EOF)
//   vhr_close(handle)
//   vhr_writer_open(path, w, h, fps, fourcc)  -> handle
//   vhr_writer_put(handle, buf, n)            -> n written
//   vhr_writer_close(handle)
//
// n_decoders > 1 enables segment-parallel decode (SURVEY §7 risk (b)):
// each worker owns a private cv::VideoCapture seeked to a disjoint
// contiguous run of chunk-aligned frame segments; chunks re-serialize
// through a sliding-window ordered buffer, so the consumer still sees
// frames strictly in order.  Seek cost note: intra-only codecs (MJPG)
// seek exactly; inter-frame codecs decode forward from the previous
// keyframe once per worker at startup.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

namespace {

struct Chunk {
  std::vector<uint8_t> data;  // (n, H, Wpad*3) or (n, frame_stride) for I420
  int n = 0;
};

struct Reader {
  std::string path;
  int width = 0, height = 0, row_bytes = 0, pad_row_bytes = 0;
  int format = 0;           // 0 = BGR rows, 1 = planar I420
  size_t frame_bytes = 0;   // bytes staged per frame (incl. padding)
  double fps = 0.0;
  int frame_count = 0;
  int chunk_frames = 0;
  int n_workers = 1;
  int64_t chunks_total = -1;  // known iff the container reports a count

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  // Ordered sliding-window staging buffer: only chunk indices in
  // [next_expected, next_expected + max_ready) may be resident, which both
  // bounds memory and guarantees the in-order consumer can always make
  // progress (the needed chunk is always admissible).
  std::map<int64_t, std::unique_ptr<Chunk>> pending;
  int64_t next_expected = 0;
  int64_t eof_chunk = std::numeric_limits<int64_t>::max();
  size_t max_ready = 3;
  int done_workers = 0;
  bool stop = false;
  // Occupancy statistics (under mu): how often each side of the pipeline
  // stalled on the other — consumer_blocked > 0 means decode is the
  // bottleneck; producer_blocked > 0 means device compute is.
  long produced = 0, consumed = 0;
  long producer_blocked = 0, consumer_blocked = 0;

  ~Reader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_full.notify_all();
    cv_empty.notify_all();
    for (auto& w : workers)
      if (w.joinable()) w.join();
  }

  // Blocks until chunk index c fits the window; returns false on stop.
  bool deliver(int64_t c, std::unique_ptr<Chunk> chunk, bool partial) {
    std::unique_lock<std::mutex> lk(mu);
    if (c >= next_expected + static_cast<int64_t>(max_ready) && !stop)
      ++producer_blocked;
    cv_full.wait(lk, [&] {
      return stop || c < next_expected + static_cast<int64_t>(max_ready);
    });
    if (stop) return false;
    if (chunk->n > 0) {
      pending[c] = std::move(chunk);
      ++produced;
    }
    if (partial)  // chunk was moved if non-empty; presence marks that case
      eof_chunk = std::min(eof_chunk,
                           pending.count(c) ? c + 1 : c);
    cv_empty.notify_all();
    return true;
  }

  void run_worker(int wid) {
    cv::VideoCapture cap(path);
    int64_t c0 = 0, c1 = std::numeric_limits<int64_t>::max();
    bool open_ok = cap.isOpened();
    if (open_ok && chunks_total >= 0) {
      int64_t per = (chunks_total + n_workers - 1) / n_workers;
      c0 = static_cast<int64_t>(wid) * per;
      c1 = std::min(chunks_total, c0 + per);
      if (c0 > 0 && c0 < c1)
        cap.set(cv::CAP_PROP_POS_FRAMES,
                static_cast<double>(c0) * chunk_frames);
    }
    if (!open_ok || c0 >= c1) {
      std::lock_guard<std::mutex> lk(mu);
      if (!open_ok) eof_chunk = std::min(eof_chunk, c0);
      ++done_workers;
      cv_empty.notify_all();
      return;
    }
    cv::Mat frame, i420;
    for (int64_t c = c0; c < c1; ++c) {
      auto chunk = std::make_unique<Chunk>();
      chunk->data.resize(static_cast<size_t>(chunk_frames) * frame_bytes);
      int n = 0;
      while (n < chunk_frames) {
        if (!cap.read(frame)) break;
        uint8_t* dst = chunk->data.data() +
                       static_cast<size_t>(n) * frame_bytes;
        if (format == 1) {
          // Planar I420 staging: (H*3/2, W) contiguous, zero-padded to the
          // 128-aligned frame stride.  cvtColor runs on the decode worker so
          // the conversion overlaps device compute like decode does.
          cv::cvtColor(frame, i420, cv::COLOR_BGR2YUV_I420);
          size_t payload = static_cast<size_t>(height) * 3 / 2 * width;
          std::memcpy(dst, i420.ptr(0), payload);
          if (frame_bytes > payload)
            std::memset(dst + payload, 0, frame_bytes - payload);
        } else {
          for (int y = 0; y < height; ++y) {
            std::memcpy(dst + static_cast<size_t>(y) * pad_row_bytes,
                        frame.ptr(y), row_bytes);
            if (pad_row_bytes > row_bytes)
              std::memset(
                  dst + static_cast<size_t>(y) * pad_row_bytes + row_bytes, 0,
                  pad_row_bytes - row_bytes);
          }
        }
        ++n;
      }
      chunk->n = n;
      bool partial = n < chunk_frames;
      if (!deliver(c, std::move(chunk), partial)) return;
      if (partial) break;  // actual EOF inside this worker's segment
    }
    std::lock_guard<std::mutex> lk(mu);
    ++done_workers;
    cv_empty.notify_all();
  }
};

struct Writer {
  cv::VideoWriter out;
  int width = 0, height = 0;
};

std::mutex g_mu;
// shared_ptr handles: calls copy the pointer out under g_mu, so a concurrent
// vhr_close/vhr_writer_close only removes the map entry and destruction
// defers until the in-flight call drops its reference (no use-after-free).
std::unordered_map<int64_t, std::shared_ptr<Reader>> g_readers;
std::unordered_map<int64_t, std::shared_ptr<Writer>> g_writers;
std::atomic<int64_t> g_next{1};

template <typename T>
std::shared_ptr<T> lookup(std::unordered_map<int64_t, std::shared_ptr<T>>& m,
                          int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = m.find(handle);
  return it == m.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int64_t vhr_open(const char* path, int chunk_frames, int pad_row_to,
                 int n_decoders, int format) {
  auto r = std::make_shared<Reader>();
  r->path = path;
  {
    cv::VideoCapture probe(path);  // metadata only; workers own their caps
    if (!probe.isOpened()) return 0;
    r->width = static_cast<int>(probe.get(cv::CAP_PROP_FRAME_WIDTH));
    r->height = static_cast<int>(probe.get(cv::CAP_PROP_FRAME_HEIGHT));
    r->fps = probe.get(cv::CAP_PROP_FPS);
    r->frame_count = static_cast<int>(probe.get(cv::CAP_PROP_FRAME_COUNT));
  }
  // I420 chroma subsampling needs even dimensions; refuse rather than crop.
  if (format == 1 && (r->width % 2 || r->height % 2)) return 0;
  r->format = format == 1 ? 1 : 0;
  r->chunk_frames = chunk_frames > 0 ? chunk_frames : 256;
  r->row_bytes = r->width * 3;
  r->pad_row_bytes = r->row_bytes;
  if (pad_row_to > 1 && r->format == 0) {
    // Pad rows to a multiple of both pad_row_to (DMA lane alignment) and 3
    // (whole BGR pixels), so chunks reshape to (n, H, W_pad, 3) exactly.
    int64_t L = pad_row_to;
    while (L % 3) L += pad_row_to;
    int64_t rem = r->row_bytes % L;
    if (rem) r->pad_row_bytes = r->row_bytes + static_cast<int>(L - rem);
  }
  if (r->format == 1) {
    size_t payload = static_cast<size_t>(r->height) * 3 / 2 * r->width;
    size_t align = pad_row_to > 1 ? static_cast<size_t>(pad_row_to) : 1;
    r->frame_bytes = (payload + align - 1) / align * align;
  } else {
    r->frame_bytes = static_cast<size_t>(r->height) * r->pad_row_bytes;
  }
  // Segment-parallel decode needs a trustworthy frame count to carve
  // chunk-aligned segments; unknown-length streams fall back to 1 worker.
  int nw = n_decoders > 1 ? (n_decoders > 8 ? 8 : n_decoders) : 1;
  if (r->frame_count > 0) {
    r->chunks_total =
        (static_cast<int64_t>(r->frame_count) + r->chunk_frames - 1) /
        r->chunk_frames;
    if (nw > r->chunks_total) nw = static_cast<int>(r->chunks_total);
  } else {
    nw = 1;
  }
  r->n_workers = nw > 0 ? nw : 1;
  // window must cover at least one in-flight chunk per worker so segment
  // starts can stage ahead without starving the in-order consumer
  if (r->max_ready < static_cast<size_t>(r->n_workers) + 1)
    r->max_ready = static_cast<size_t>(r->n_workers) + 1;
  Reader* raw = r.get();
  for (int w = 0; w < r->n_workers; ++w)
    raw->workers.emplace_back([raw, w] { raw->run_worker(w); });
  int64_t h = g_next.fetch_add(1);
  std::lock_guard<std::mutex> lk(g_mu);
  g_readers[h] = std::move(r);
  return h;
}

int vhr_meta(int64_t handle, double* out5) {
  auto r = lookup(g_readers, handle);
  if (!r) return 0;
  out5[0] = r->width;
  out5[1] = r->height;
  out5[2] = r->fps;
  out5[3] = r->frame_count;
  // BGR: padded width in pixels; I420: staged frame stride in bytes.
  out5[4] = r->format == 1 ? static_cast<double>(r->frame_bytes)
                           : r->pad_row_bytes / 3.0;
  return 1;
}

// Blocks until the next in-order chunk is ready (or EOF).  Returns frames
// copied.
int vhr_next_chunk(int64_t handle, uint8_t* buf, int64_t buf_bytes) {
  auto r = lookup(g_readers, handle);
  if (!r) return -1;
  std::unique_ptr<Chunk> chunk;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    auto readyp = [&] {
      return r->stop || r->pending.count(r->next_expected) ||
             r->next_expected >= r->eof_chunk ||
             r->done_workers == r->n_workers;
    };
    if (!readyp()) ++r->consumer_blocked;
    r->cv_empty.wait(lk, readyp);
    if (r->stop) return 0;
    auto it = r->pending.find(r->next_expected);
    if (it == r->pending.end()) {
      if (r->next_expected >= r->eof_chunk || r->pending.empty())
        return 0;  // EOF
      // All workers done but a gap precedes buffered chunks (container
      // frame-count estimate vs. reality); skip to what exists.
      r->next_expected = r->pending.begin()->first;
      it = r->pending.find(r->next_expected);
    }
    chunk = std::move(it->second);
    r->pending.erase(it);
    ++r->next_expected;
    ++r->consumed;
  }
  r->cv_full.notify_all();
  int64_t need = static_cast<int64_t>(chunk->n) * r->frame_bytes;
  if (need > buf_bytes) return -2;
  std::memcpy(buf, chunk->data.data(), need);
  return chunk->n;
}

// Staging-ring stats: produced, consumed, producer_blocked, consumer_blocked.
int vhr_stats(int64_t handle, double* out4) {
  auto r = lookup(g_readers, handle);
  if (!r) return 0;
  std::lock_guard<std::mutex> lk(r->mu);
  out4[0] = static_cast<double>(r->produced);
  out4[1] = static_cast<double>(r->consumed);
  out4[2] = static_cast<double>(r->producer_blocked);
  out4[3] = static_cast<double>(r->consumer_blocked);
  return 1;
}

void vhr_close(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_readers.erase(handle);
}

int64_t vhr_writer_open(const char* path, int width, int height, double fps,
                        const char* fourcc) {
  auto w = std::make_shared<Writer>();
  int fcc = cv::VideoWriter::fourcc(fourcc[0], fourcc[1], fourcc[2], fourcc[3]);
  if (!w->out.open(path, fcc, fps, cv::Size(width, height))) return 0;
  w->width = width;
  w->height = height;
  int64_t h = g_next.fetch_add(1);
  std::lock_guard<std::mutex> lk(g_mu);
  g_writers[h] = std::move(w);
  return h;
}

int vhr_writer_put(int64_t handle, const uint8_t* buf, int n) {
  auto w = lookup(g_writers, handle);
  if (!w) return -1;
  size_t frame_bytes = static_cast<size_t>(w->width) * w->height * 3;
  for (int i = 0; i < n; ++i) {
    cv::Mat m(w->height, w->width, CV_8UC3,
              const_cast<uint8_t*>(buf + i * frame_bytes));
    w->out.write(m);
  }
  return n;
}

void vhr_writer_close(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_writers.erase(handle);
}

}  // extern "C"
