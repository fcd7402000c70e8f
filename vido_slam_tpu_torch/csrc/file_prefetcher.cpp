// Threaded file prefetcher of the port (vido_slam_tpu_torch/io/native.py):
// worker threads read whole files ahead of the consumer, at most max_ahead
// past the next index it is served, so that disk latency overlaps compute.
// The prefetcher of the JAX package's native/dataloader.cpp:107-191 under
// the same C names and with the same behaviour: a file that cannot be
// opened or read comes out empty, vido_prefetcher_get blocks until its
// index is read and returns -1 once every file has been read and served.
// One repair: the JAX package's end-of-list test races with a worker still
// reading the last file it took (see vido_prefetcher_get).
//
// Built at first use by utils/host_build.py (g++ -O2 -pthread).

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

extern "C" {

// ---------------------------------------------------------------------------
// Threaded file prefetcher.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  std::deque<std::pair<int, std::vector<uint8_t>>> ready;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<int> next_to_read{0};
  std::atomic<bool> stop{false};
  size_t max_ahead = 8;
  int next_to_serve = 0;
  int n_pushed = 0;  // files put into ready (under mu)
  std::vector<std::thread> workers;

  void worker() {
    while (!stop.load()) {
      int idx = next_to_read.fetch_add(1);
      if (idx >= (int)paths.size()) return;
      std::vector<uint8_t> data;
      FILE* f = fopen(paths[idx].c_str(), "rb");
      if (f) {
        fseek(f, 0, SEEK_END);
        long sz = ftell(f);
        fseek(f, 0, SEEK_SET);
        data.resize(sz);
        if (fread(data.data(), 1, sz, f) != (size_t)sz) data.clear();
        fclose(f);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] {
        return stop.load() || ready.size() < max_ahead ||
               idx < next_to_serve + (int)max_ahead;
      });
      if (stop.load()) return;
      ready.emplace_back(idx, std::move(data));
      ++n_pushed;
      cv.notify_all();
    }
  }
};

void* vido_prefetcher_create(const char** paths, int n, int n_threads,
                             int max_ahead) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->max_ahead = max_ahead > 0 ? max_ahead : 8;
  for (int i = 0; i < (n_threads > 0 ? n_threads : 2); ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until file `idx` is available; returns its size (or -1) and copies
// up to max_bytes into buf (buf=null: just report the size and keep it).
int64_t vido_prefetcher_get(void* handle, int idx, uint8_t* buf,
                            int64_t max_bytes) {
  auto* p = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  for (;;) {
    for (auto it = p->ready.begin(); it != p->ready.end(); ++it) {
      if (it->first == idx) {
        int64_t sz = (int64_t)it->second.size();
        if (buf == nullptr) return sz;
        if (sz > max_bytes) return -2;
        std::memcpy(buf, it->second.data(), sz);
        p->ready.erase(it);
        p->next_to_serve = idx + 1;
        p->cv.notify_all();
        return sz;
      }
    }
    // every file read and served: the JAX package checks next_to_read
    // here, which a worker passes when it takes the last index, before it
    // has read the file, so a consumer could be told -1 for a file still
    // in flight
    if (p->n_pushed >= (int)p->paths.size() && p->ready.empty()) return -1;
    p->cv.wait(lk);
  }
}

void vido_prefetcher_destroy(void* handle) {
  auto* p = (Prefetcher*)handle;
  p->stop.store(true);
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
