// The port's sink runtime: bounded ring FIFO, streaming IQ file writer and
// paced stream writer, with always-on counters of the FIFO.
//
// The same design as the shared host runtime (native/gpssim_native.cc: the
// reference's pthread FIFO, fifo.c, with a fixed pool of preallocated
// buffers, blocking acquire as real-time backpressure, the wait_full start
// barrier and halt teardown; the IQ file consumer thread, sdr_iqfile.c:
// 22-77), exposed through a plain C ABI for ctypes (io/native.py). Each
// FIFO also counts, in enum Stat's order, what the benchmark's sink
// metrics read: the producer's wait for a free buffer, its copy into the
// ring, the queued depth at each dequeue, and the blocks lent to it.
//
// A block is either copied into a ring buffer (put) or lent (lend): the
// queue entry then points at the caller's memory, and the drain writes
// from it. A lent block still takes a ring slot, so the depth, the
// backpressure and the start barrier are those of a copied one. The caller
// keeps a lent block alive, unchanged, until kLentDone counts it (the
// drain is FIFO, so a count says which) or until the drain thread is
// joined.
//
// Built by io/native.py with g++ at first use, into build/native/ under a
// name that hashes this file.

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <poll.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

inline long long now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// The counters of one FIFO, read through gwriter_stats / gstream_stats as
// int64[kStatCount] in this order (io/native.FIFO_STATS).
enum Stat {
  kAcquireWaitNs,  // ns the producer waited in acquire() for a free buffer
  kCopyNs,         // ns the producer spent copying into the ring
  kDepthSum,       // queued blocks, the taken one included, summed at each
  kDequeued,       //   dequeue; and the blocks dequeued
  kLent,           // blocks queued without a copy (lend)
  kLentDone,       // lent blocks the drain has finished with
  kStatCount
};

// One queued entry: the ring slot it holds, the bytes to write (the slot
// itself, or the caller's memory for a lent block), and whether the drain
// counts kLentDone once it has written them (the last part of a lent
// block).
struct Entry {
  uint8_t* slot;
  const uint8_t* data;
  long nbytes;
  bool lent_last;
};

// ---------------------------------------------------------------------------
// Ring FIFO of fixed-size blocks (reference fifo.c semantics).
// ---------------------------------------------------------------------------
struct Fifo {
  explicit Fifo(int nbuf, long block_bytes)
      : block_bytes(block_bytes), storage(nbuf) {
    for (auto& b : storage) {
      b.resize(static_cast<size_t>(block_bytes));
      freelist.push_back(b.data());
    }
  }

  long block_bytes;
  std::vector<std::vector<uint8_t>> storage;
  std::deque<uint8_t*> freelist;  // fifo.c freelist
  std::deque<Entry> q;            // queued entries
  std::mutex mu;
  std::condition_variable not_empty, not_full, full_once;
  bool halted = false;
  bool filled_once = false;
  std::atomic<long long> stat[kStatCount] = {};

  // Producer: blocking acquire of a free buffer (fifo.c:128-148 — an empty
  // freelist is the backpressure signal).
  uint8_t* acquire() {
    std::unique_lock<std::mutex> lk(mu);
    if (freelist.empty() && !halted) {
      long long t0 = now_ns();
      while (freelist.empty() && !halted) {
        full_once.notify_all();
        filled_once = true;
        not_full.wait(lk);
      }
      stat[kAcquireWaitNs] += now_ns() - t0;
    }
    if (halted) return nullptr;
    uint8_t* b = freelist.front();
    freelist.pop_front();
    return b;
  }

  bool enqueue(const Entry& e) {
    std::unique_lock<std::mutex> lk(mu);
    if (halted) return false;
    q.push_back(e);
    if (freelist.empty()) {
      filled_once = true;
      full_once.notify_all();
    }
    not_empty.notify_one();
    return true;
  }

  // Producer: copy caller data into ring buffers, blocking when the ring is
  // full — that blocking IS the real-time pacing of the pipeline.
  bool put(const uint8_t* data, long nbytes) {
    while (nbytes > 0) {
      uint8_t* buf = acquire();
      if (!buf) return false;
      long n = nbytes < block_bytes ? nbytes : block_bytes;
      long long t0 = now_ns();
      std::memcpy(buf, data, static_cast<size_t>(n));
      stat[kCopyNs] += now_ns() - t0;
      if (!enqueue({buf, buf, n, false})) return false;
      data += n;
      nbytes -= n;
    }
    return true;
  }

  // Producer: queue the caller's memory itself, one ring slot for each
  // block_bytes of it, as put() would have copied it. No copy.
  bool lend(const uint8_t* data, long nbytes) {
    ++stat[kLent];
    if (nbytes <= 0) {
      ++stat[kLentDone];
      return true;
    }
    while (nbytes > 0) {
      uint8_t* slot = acquire();
      if (!slot) return false;
      long n = nbytes < block_bytes ? nbytes : block_bytes;
      if (!enqueue({slot, data, n, n == nbytes})) return false;
      data += n;
      nbytes -= n;
    }
    return true;
  }

  // Consumer: blocking dequeue; false on halt-and-drained.
  bool dequeue(Entry* out) {
    std::unique_lock<std::mutex> lk(mu);
    while (q.empty() && !halted) not_empty.wait(lk);
    if (q.empty()) return false;
    stat[kDepthSum] += static_cast<long long>(q.size());
    ++stat[kDequeued];
    *out = q.front();
    q.pop_front();
    return true;
  }

  // Consumer: the drain has finished with the entry's bytes.
  void release(const Entry& e) {
    if (e.lent_last) ++stat[kLentDone];
    std::unique_lock<std::mutex> lk(mu);
    freelist.push_back(e.slot);
    not_full.notify_one();
  }

  // Stream-start barrier (fifo_wait_full, fifo.c:97-103).
  bool wait_full(double timeout_s) {
    std::unique_lock<std::mutex> lk(mu);
    auto dl = std::chrono::steady_clock::now() +
              std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                  std::chrono::duration<double>(timeout_s));
    // Predicate form: a spurious wakeup must not end the wait early.
    full_once.wait_until(lk, dl, [&] { return filled_once || halted; });
    return filled_once;
  }

  // Teardown: wake everyone; consumers drain what is queued (fifo.c:105-126
  // clears the queue — here the writer drains so no samples are lost).
  void halt() {
    std::unique_lock<std::mutex> lk(mu);
    halted = true;
    not_empty.notify_all();
    not_full.notify_all();
    full_once.notify_all();
  }

  int depth_used() {
    std::unique_lock<std::mutex> lk(mu);
    return static_cast<int>(q.size());
  }

  bool empty_and_live() {
    std::unique_lock<std::mutex> lk(mu);
    return q.empty() && !halted;
  }

  void read_stats(long long* out) {
    for (int k = 0; k < kStatCount; ++k) out[k] = stat[k].load();
  }
};

// ---------------------------------------------------------------------------
// Streaming file writer: FIFO + drain thread (sdr_iqfile.c:22-77).
// ---------------------------------------------------------------------------
struct Writer {
  Writer(const char* path, int nbuf, long block_bytes)
      : fifo(nbuf, block_bytes) {
    fp = std::fopen(path, "wb");
    if (fp) th = std::thread(&Writer::drain, this);
  }

  Fifo fifo;
  std::FILE* fp = nullptr;
  std::thread th;
  std::atomic<long long> bytes_written{0};
  std::atomic<bool> io_error{false};

  void drain() {
    for (;;) {
      Entry e;
      if (!fifo.dequeue(&e)) return;  // halted and drained
      size_t n = static_cast<size_t>(e.nbytes);
      size_t w = std::fwrite(e.data, 1, n, fp);
      if (w != n) io_error = true;
      bytes_written += static_cast<long long>(w);
      fifo.release(e);
    }
  }

  bool write(const uint8_t* data, long nbytes) {
    return fifo.put(data, nbytes) && !io_error;
  }

  // The lent blocks the drain has finished with, or -1 on failure.
  long long lend(const uint8_t* data, long nbytes) {
    if (!fifo.lend(data, nbytes) || io_error) return -1;
    return fifo.stat[kLentDone].load();
  }

  // Flush and stop the drain thread, then close the file; idempotent (a
  // second call returns 0, or -2 after an I/O error).
  int close() {
    fifo.halt();
    if (th.joinable()) th.join();
    int rc = 0;
    if (fp) {
      if (std::fclose(fp) != 0) rc = -1;
      fp = nullptr;
    }
    return io_error ? -2 : rc;
  }

  ~Writer() {
    if (fp) close();
  }
};

// ---------------------------------------------------------------------------
// Realtime TX streamer: FIFO + paced drain thread over a file descriptor
// (socket, pipe, character device).
//
// Implements the reference's TX contract that the file sink skips:
//   * start-full barrier — transmission begins only once the FIFO has
//     filled once (fifo_wait_full, fifo.c:97-103; sdr_iqfile.c:74), so the
//     pre-buffer absorbs producer jitter from sample zero;
//   * hardware pacing — blocks leave at the sample rate (the role the
//     SDR's DAC clock plays in sdr_hackrf.c/sdr_pluto.c);
//   * underrun accounting — a block whose transmit time arrives while the
//     FIFO is empty is an underrun (the radio would have starved).
// ---------------------------------------------------------------------------
struct Streamer {
  Streamer(int fd, int nbuf, long block_bytes, double bytes_per_sec,
           double start_timeout_s)
      : fifo(nbuf, block_bytes), fd(fd), bytes_per_sec(bytes_per_sec),
        start_timeout_s(start_timeout_s) {
    // Non-blocking writes + poll: a peer that stops reading leaves the
    // drain in bounded 100 ms poll slices (abortable from finish())
    // instead of stuck forever inside a blocking ::write.
    int fl = fcntl(fd, F_GETFL, 0);
    if (fl >= 0) fcntl(fd, F_SETFL, fl | O_NONBLOCK);
    th = std::thread(&Streamer::drain, this);
  }

  Fifo fifo;
  int fd;
  double bytes_per_sec;   // 0 = unpaced (drain as fast as the fd accepts)
  double start_timeout_s;
  std::thread th;
  std::atomic<long long> bytes_sent{0};
  std::atomic<long> underruns{0};
  std::atomic<bool> io_error{false};
  std::atomic<bool> started{false};
  std::atomic<bool> drain_done{false};
  std::atomic<bool> abort_io{false};

  void drain() {
    drain_loop();
    drain_done = true;
  }

  void drain_loop() {
    // Start barrier: no byte leaves until the FIFO has filled once (or
    // the producer finished early / halted).
    fifo.wait_full(start_timeout_s);
    started = true;
    auto t0 = std::chrono::steady_clock::now();
    for (;;) {
      if (bytes_per_sec > 0.0) {
        // This block is due when every byte before it has left at the
        // DAC rate; a due-but-empty FIFO is an underrun.
        auto due = t0 + std::chrono::duration_cast<
                            std::chrono::steady_clock::duration>(
                            std::chrono::duration<double>(
                                bytes_sent.load() / bytes_per_sec));
        std::this_thread::sleep_until(due);
        if (fifo.empty_and_live()) ++underruns;
      }
      Entry e;
      if (!fifo.dequeue(&e)) return;  // halted and drained
      const uint8_t* p = e.data;
      long n = e.nbytes;
      while (n > 0 && !io_error) {
        if (abort_io) {  // finish() gave up on a stalled peer
          io_error = true;
          break;
        }
        ssize_t w = ::write(fd, p, static_cast<size_t>(n));
        if (w < 0) {
          if (errno == EINTR) continue;
          if (errno == EAGAIN || errno == EWOULDBLOCK) {
            // A full send buffer is backpressure, not an I/O error:
            // wait for writability in short abortable slices.
            struct pollfd pfd = {fd, POLLOUT, 0};
            ::poll(&pfd, 1, 100);
            continue;
          }
          io_error = true;
          break;
        }
        p += w;
        n -= static_cast<long>(w);
        bytes_sent += static_cast<long long>(w);
      }
      fifo.release(e);
      if (io_error) {
        // Nobody is reading: halt so the producer unblocks with an error
        // instead of deadlocking on acquire.
        fifo.halt();
        return;
      }
    }
  }

  bool write(const uint8_t* data, long nbytes) {
    return fifo.put(data, nbytes) && !io_error;
  }

  // The lent blocks the drain has finished with, or -1 on failure.
  long long lend(const uint8_t* data, long nbytes) {
    if (!fifo.lend(data, nbytes) || io_error) return -1;
    return fifo.stat[kLentDone].load();
  }

  // Halt and flush (the drain sends queued blocks at the paced rate);
  // idempotent, stats remain readable afterwards.  The flush is bounded:
  // past the deadline a stalled peer is abandoned (abort_io) rather than
  // hanging the caller forever.
  int finish(double flush_timeout_s = 10.0) {
    fifo.halt();
    if (th.joinable()) {
      auto deadline = std::chrono::steady_clock::now() +
                      std::chrono::duration_cast<
                          std::chrono::steady_clock::duration>(
                          std::chrono::duration<double>(flush_timeout_s));
      while (!drain_done && std::chrono::steady_clock::now() < deadline) {
        std::this_thread::sleep_for(std::chrono::milliseconds(5));
      }
      if (!drain_done) abort_io = true;  // drain exits within one poll slice
      th.join();
    }
    return io_error ? -2 : 0;
  }

  ~Streamer() { finish(); }
};

}  // namespace

extern "C" {

// ---- Writer C ABI ----
void* gwriter_open(const char* path, int nbuf, long block_bytes) {
  Writer* w = new Writer(path, nbuf, block_bytes);
  if (!w->fp) {
    delete w;
    return nullptr;
  }
  return w;
}
int gwriter_write(void* w, const void* data, long nbytes) {
  return static_cast<Writer*>(w)->write(static_cast<const uint8_t*>(data),
                                        nbytes);
}
// Queue the caller's block without a copy; the caller keeps it alive and
// unchanged until the returned count of finished lent blocks includes it,
// or until gwriter_finish. Returns that count, or -1 on failure.
long long gwriter_lend(void* w, const void* data, long nbytes) {
  return static_cast<Writer*>(w)->lend(static_cast<const uint8_t*>(data),
                                       nbytes);
}
int gwriter_depth_used(void* w) {
  return static_cast<Writer*>(w)->fifo.depth_used();
}
long long gwriter_bytes_written(void* w) {
  return static_cast<Writer*>(w)->bytes_written.load();
}
// The FIFO's counters (enum Stat) into out[kStatCount]; final after
// gwriter_finish, valid until gwriter_close.
void gwriter_stats(void* w, long long* out) {
  static_cast<Writer*>(w)->fifo.read_stats(out);
}
// Flush and stop the drain thread and close the file; the handle (and its
// stats) stays valid until gwriter_close.
int gwriter_finish(void* w) { return static_cast<Writer*>(w)->close(); }
int gwriter_close(void* w) {
  Writer* wr = static_cast<Writer*>(w);
  int rc = wr->close();
  delete wr;
  return rc;
}

// ---- Realtime TX streamer C ABI ----
void* gstream_open(int fd, int nbuf, long block_bytes, double bytes_per_sec,
                   double start_timeout_s) {
  return new Streamer(fd, nbuf, block_bytes, bytes_per_sec, start_timeout_s);
}
int gstream_write(void* s, const void* data, long nbytes) {
  return static_cast<Streamer*>(s)->write(static_cast<const uint8_t*>(data),
                                          nbytes);
}
// As gwriter_lend; the block is kept until the count includes it or until
// gstream_finish.
long long gstream_lend(void* s, const void* data, long nbytes) {
  return static_cast<Streamer*>(s)->lend(static_cast<const uint8_t*>(data),
                                         nbytes);
}
int gstream_depth_used(void* s) {
  return static_cast<Streamer*>(s)->fifo.depth_used();
}
long long gstream_bytes_sent(void* s) {
  return static_cast<Streamer*>(s)->bytes_sent.load();
}
long gstream_underruns(void* s) {
  return static_cast<Streamer*>(s)->underruns.load();
}
int gstream_started(void* s) {
  return static_cast<Streamer*>(s)->started.load();
}
// The FIFO's counters (enum Stat) into out[kStatCount]; final after
// gstream_finish.
void gstream_stats(void* s, long long* out) {
  static_cast<Streamer*>(s)->fifo.read_stats(out);
}
// Flush and stop the drain thread; the handle (and its stats) stays valid
// until gstream_close.
int gstream_finish(void* s, double flush_timeout_s) {
  return static_cast<Streamer*>(s)->finish(flush_timeout_s);
}
// End-of-stream marker WITHOUT waiting for the flush: halts the FIFO so
// the paced drain stops counting a drained-out tail as underruns (the
// stream is complete — no byte is late), then returns immediately.  A
// multi-stream producer calls this on EVERY sink before the per-sink
// blocking closes; otherwise sink k's flush wait would turn sinks k+1..N
// into false underrun counters.
int gstream_halt(void* s) {
  static_cast<Streamer*>(s)->fifo.halt();
  return 0;
}
int gstream_close(void* s) {
  Streamer* st = static_cast<Streamer*>(s);
  int rc = st->finish();
  delete st;
  return rc;
}

}  // extern "C"
