// Native RecordIO reader of mxnet_tpu_torch (the port's own copy of the
// C++ data plane: RecordIO frame reading + a dmlc::ThreadedIter-style
// prefetch thread, the reference's src/io/ and iter_prefetcher.h:47).
//
// Wire format (dmlc-core recordio, byte-compatible with
// mxnet_tpu_torch/recordio.py): little-endian <uint32 magic=0xced7230a>
// <uint32 word>, kind = word >> 29, length = word & ((1<<29)-1),
// payload padded to a 4-byte boundary.
//
// A flat C ABI loaded with ctypes (mxnet_tpu_torch/io/native.py), no
// Python.h. Built at first use by io/native.py:
//   g++ -O3 -std=c++17 -fPIC -shared -pthread -o <lib> recordio_io.cc
// into mxnet_tpu_torch/_build/, named by the SHA-256 of this file.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = (1u << 29) - 1;
constexpr size_t kChunkBytes = 4u << 20;  // 4 MiB buffered reads

struct Reader {
  FILE* fp = nullptr;
  std::vector<uint8_t> buf;   // buffered window of the file
  size_t pos = 0;             // cursor inside buf
  size_t valid = 0;           // valid bytes in buf
  uint64_t base = 0;          // file offset of buf[0]
  std::vector<uint8_t> record;  // last returned payload
  std::string error;

  bool fill(size_t need) {
    // keep [pos, valid) and append until at least `need` bytes remain
    if (valid - pos >= need) return true;
    if (pos > 0) {
      std::memmove(buf.data(), buf.data() + pos, valid - pos);
      base += pos;
      valid -= pos;
      pos = 0;
    }
    if (buf.size() < need) buf.resize(std::max(need, kChunkBytes));
    while (valid < need) {
      size_t got = std::fread(buf.data() + valid, 1,
                              buf.size() - valid, fp);
      if (got == 0) return false;  // EOF / error
      valid += got;
    }
    return true;
  }
};

struct Prefetcher {
  // dmlc::ThreadedIter role: ONE producer thread reads frames ahead of
  // the consumer into a bounded deque (records are variable-length, so
  // a deque of vectors; the bound is on total queued payload bytes).
  Reader reader;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<std::vector<uint8_t>> queue;
  size_t queued_bytes = 0;
  size_t capacity_bytes;
  std::atomic<bool> done{false}, stop{false};
  std::vector<uint8_t> current;
};

int read_frame(Reader* r, const uint8_t** data, uint64_t* len) {
  if (!r->fill(8)) return 0;  // clean EOF
  uint32_t magic, word;
  std::memcpy(&magic, r->buf.data() + r->pos, 4);
  std::memcpy(&word, r->buf.data() + r->pos + 4, 4);
  if (magic != kMagic) {
    char msg[96];
    std::snprintf(msg, sizeof(msg),
                  "corrupt RecordIO stream: bad magic 0x%08x at offset"
                  " %llu", magic,
                  (unsigned long long)(r->base + r->pos));
    r->error = msg;
    return -1;
  }
  uint32_t length = word & kLenMask;
  size_t padded = 8 + length + ((4 - (length % 4)) % 4);
  if (!r->fill(padded)) {
    r->error = "truncated record at end of file";
    return -1;
  }
  r->record.assign(r->buf.data() + r->pos + 8,
                   r->buf.data() + r->pos + 8 + length);
  r->pos += padded;
  *data = r->record.data();
  *len = length;
  return 1;
}

void prefetch_loop(Prefetcher* p) {
  const uint8_t* data;
  uint64_t len;
  for (;;) {
    if (p->stop.load()) break;
    int rc = read_frame(&p->reader, &data, &len);
    if (rc <= 0) break;  // EOF or error (error string kept in reader)
    std::vector<uint8_t> rec(data, data + len);
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_put.wait(lk, [&] {
      return p->stop.load() || p->queued_bytes < p->capacity_bytes ||
             p->queue.empty();
    });
    if (p->stop.load()) break;
    p->queued_bytes += rec.size();
    p->queue.emplace_back(std::move(rec));
    p->cv_get.notify_one();
  }
  p->done.store(true);
  std::lock_guard<std::mutex> lk(p->mu);
  p->cv_get.notify_all();
}

}  // namespace

extern "C" {

// ---- sequential buffered reader ------------------------------------------

void* mxtpu_rec_open(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  Reader* r = new Reader();
  r->fp = fp;
  return r;
}

// 1 = record produced, 0 = clean EOF, -1 = corrupt stream
int mxtpu_rec_next(void* handle, const uint8_t** data, uint64_t* len) {
  return read_frame(static_cast<Reader*>(handle), data, len);
}

void mxtpu_rec_seek(void* handle, uint64_t offset) {
  Reader* r = static_cast<Reader*>(handle);
  std::fseek(r->fp, (long)offset, SEEK_SET);
  r->pos = r->valid = 0;
  r->base = offset;
}

const char* mxtpu_rec_error(void* handle) {
  return static_cast<Reader*>(handle)->error.c_str();
}

void mxtpu_rec_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r->fp) std::fclose(r->fp);
  delete r;
}

// ---- threaded prefetcher --------------------------------------------------

void* mxtpu_prefetch_open(const char* path, uint64_t capacity_bytes) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  Prefetcher* p = new Prefetcher();
  p->reader.fp = fp;
  p->capacity_bytes = capacity_bytes ? capacity_bytes : (64u << 20);
  p->worker = std::thread(prefetch_loop, p);
  return p;
}

// 1 = record produced, 0 = stream drained, -1 = corrupt stream
int mxtpu_prefetch_next(void* handle, const uint8_t** data,
                        uint64_t* len) {
  Prefetcher* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_get.wait(lk, [&] {
    return !p->queue.empty() || p->done.load();
  });
  if (p->queue.empty()) {
    return p->reader.error.empty() ? 0 : -1;
  }
  p->current = std::move(p->queue.front());
  p->queue.pop_front();
  p->queued_bytes -= p->current.size();
  p->cv_put.notify_one();
  *data = p->current.data();
  *len = p->current.size();
  return 1;
}

const char* mxtpu_prefetch_error(void* handle) {
  return static_cast<Prefetcher*>(handle)->reader.error.c_str();
}

void mxtpu_prefetch_close(void* handle) {
  Prefetcher* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->cv_put.notify_all();
    p->cv_get.notify_all();
  }
  if (p->worker.joinable()) p->worker.join();
  if (p->reader.fp) std::fclose(p->reader.fp);
  delete p;
}

}  // extern "C"
