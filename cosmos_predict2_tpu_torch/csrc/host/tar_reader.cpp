// Native tar-shard reader with a background prefetch thread pool.
//
// Fills the role of the reference's native data-loading layer (decord C++
// decode + webdataset tar streaming, SURVEY.md §2.10 / §2.7): tar parsing,
// file IO and buffer management run off the Python GIL in pthreads; Python
// only sees filled sample buffers. Designed for a host with few cores —
// IO overlaps with the train step instead of stealing interpreter time.
//
// API (ctypes):
//   tar_index_open(path)            -> handle (parses all 512-byte headers)
//   tar_index_count(h)              -> number of regular files
//   tar_index_name(h, i)            -> entry name (borrowed char*)
//   tar_index_size(h, i)            -> payload size
//   tar_read(h, i, dst)             -> synchronous read into dst
//   tar_prefetch_start(h, idx*, n, n_threads) -> begin async loads
//   tar_prefetch_get(h, slot, dst)  -> block until sample `slot` ready, copy
//   tar_prefetch_stop(h) / tar_index_close(h)
//
// Built by cosmos_predict2_tpu_torch/data/native_tar.py on first use, with g++
// -O3 -shared -fPIC -pthread, into build/cosmos_torch_host/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Entry {
    std::string name;
    int64_t offset;  // payload offset in the tar
    int64_t size;
};

struct Prefetched {
    std::vector<uint8_t> data;
    std::atomic<bool> ready{false};
};

struct TarIndex {
    FILE* f = nullptr;
    std::mutex io_mu;
    std::vector<Entry> entries;

    // prefetch state
    std::vector<int64_t> queue;            // entry indices to load
    std::vector<Prefetched> slots;         // one per queued index
    std::atomic<int64_t> next{0};
    std::vector<std::thread> workers;
    std::mutex cv_mu;
    std::condition_variable cv;
    std::atomic<bool> stopping{false};
};

int64_t octal(const char* p, int n) {
    int64_t v = 0;
    for (int i = 0; i < n && p[i]; ++i) {
        if (p[i] < '0' || p[i] > '7') continue;
        v = v * 8 + (p[i] - '0');
    }
    return v;
}

void read_at(TarIndex* t, int64_t off, int64_t size, uint8_t* dst) {
    std::lock_guard<std::mutex> g(t->io_mu);
    std::fseek(t->f, static_cast<long>(off), SEEK_SET);
    size_t got = std::fread(dst, 1, static_cast<size_t>(size), t->f);
    (void)got;
}

void worker_loop(TarIndex* t) {
    while (!t->stopping.load()) {
        int64_t slot = t->next.fetch_add(1);
        if (slot >= static_cast<int64_t>(t->queue.size())) return;
        const Entry& e = t->entries[t->queue[slot]];
        auto& p = t->slots[slot];
        p.data.resize(e.size);
        read_at(t, e.offset, e.size, p.data.data());
        {
            // store under the cv mutex: otherwise a waiter can check the
            // predicate, lose the race to this store+notify, then sleep
            // forever (lost wakeup)
            std::lock_guard<std::mutex> g(t->cv_mu);
            p.ready.store(true);
        }
        t->cv.notify_all();
    }
}

}  // namespace

extern "C" {

void* tar_index_open(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    auto* t = new TarIndex();
    t->f = f;
    char hdr[512];
    int64_t pos = 0;
    while (std::fread(hdr, 1, 512, f) == 512) {
        pos += 512;
        if (hdr[0] == '\0') break;  // end-of-archive zero block
        int64_t size = octal(hdr + 124, 12);
        char type = hdr[156];
        std::string name(hdr, strnlen(hdr, 100));
        // GNU long names (type 'L'): next block holds the real name
        if (type == 'L') {
            int64_t blocks = (size + 511) / 512;
            std::vector<char> nm(blocks * 512);
            if (std::fread(nm.data(), 1, nm.size(), f) != nm.size()) break;
            pos += blocks * 512;
            if (std::fread(hdr, 1, 512, f) != 512) break;
            pos += 512;
            size = octal(hdr + 124, 12);
            type = hdr[156];
            name.assign(nm.data(), strnlen(nm.data(), blocks * 512));
        }
        if (type == '0' || type == '\0') {
            t->entries.push_back({name, pos, size});
        }
        int64_t blocks = (size + 511) / 512;
        std::fseek(f, static_cast<long>(blocks * 512), SEEK_CUR);
        pos += blocks * 512;
    }
    return t;
}

int64_t tar_index_count(void* h) { return static_cast<TarIndex*>(h)->entries.size(); }

const char* tar_index_name(void* h, int64_t i) {
    return static_cast<TarIndex*>(h)->entries[i].name.c_str();
}

int64_t tar_index_size(void* h, int64_t i) {
    return static_cast<TarIndex*>(h)->entries[i].size;
}

void tar_read(void* h, int64_t i, uint8_t* dst) {
    auto* t = static_cast<TarIndex*>(h);
    const Entry& e = t->entries[i];
    read_at(t, e.offset, e.size, dst);
}

void tar_prefetch_start(void* h, const int64_t* idx, int64_t n, int64_t n_threads) {
    auto* t = static_cast<TarIndex*>(h);
    t->queue.assign(idx, idx + n);
    t->slots = std::vector<Prefetched>(n);
    t->next.store(0);
    t->stopping.store(false);
    for (int64_t i = 0; i < n_threads; ++i) t->workers.emplace_back(worker_loop, t);
}

void tar_prefetch_get(void* h, int64_t slot, uint8_t* dst) {
    auto* t = static_cast<TarIndex*>(h);
    auto& p = t->slots[slot];
    if (!p.ready.load()) {
        std::unique_lock<std::mutex> lk(t->cv_mu);
        t->cv.wait(lk, [&] { return p.ready.load(); });
    }
    std::memcpy(dst, p.data.data(), p.data.size());
    p.data.clear();
    p.data.shrink_to_fit();
}

void tar_prefetch_stop(void* h) {
    auto* t = static_cast<TarIndex*>(h);
    t->stopping.store(true);
    for (auto& w : t->workers) w.join();
    t->workers.clear();
    t->slots.clear();
}

void tar_index_close(void* h) {
    auto* t = static_cast<TarIndex*>(h);
    tar_prefetch_stop(h);
    if (t->f) std::fclose(t->f);
    delete t;
}

}  // extern "C"
