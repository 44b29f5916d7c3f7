// The port's native runtime: native/hacktv_rt.cpp as it is, found on the
// include path, and the port's own file sink.  Built by
// hacktv_tpu_torch/runtime.py with g++ -I <the directory of hacktv_rt.cpp>.

#include "hacktv_rt.cpp"

#include <chrono>
#include <deque>

static inline int64_t _port_now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

// ---------------------------------------------------------------------------
// The file sink borrows the caller's int16 I/Q arrays: a submit queues the
// array's pointer and returns, and the sink's writer thread writes the
// bytes to the file straight from it (int16 complex output), or converts
// them into its own scratch buffer first (any other type, or real output).
// The caller keeps each array alive, unwritten, until rt_port_sink_done
// reaches the sequence number its submit returned.
// ---------------------------------------------------------------------------

struct rt_port_sink_item {
    const int16_t *iq;
    size_t pairs;
    size_t nbytes;      // bytes it makes in the file
    int64_t seq;
};

struct rt_port_sink {
    FILE *f = nullptr;
    bool own_file = false;
    int type = RT_S16;
    int complex_out = 1;
    size_t bound = 0;           // submits wait while this much is in flight
    std::deque<rt_port_sink_item> queue;
    std::mutex m;
    std::condition_variable cv_work, cv_room;
    bool closing = false;
    size_t in_flight = 0;       // bytes submitted and not yet written
    int64_t next_seq = 1;
    // under m: ns converting, ns submits waited for room, bytes in, the
    // most bytes in flight, writes borrowed with no copy
    int64_t counts[5] = {0, 0, 0, 0, 0};
    std::atomic<int64_t> written{0};    // the last sequence written
    std::atomic<long> io_error{0};
    std::thread writer;
    std::vector<uint8_t> scratch;       // the writer thread's
};

static bool _port_borrows(const rt_port_sink *s) {
    return s->type == RT_S16 && s->complex_out;
}

static void _port_writer_main(rt_port_sink *s) {
    for (;;) {
        rt_port_sink_item it;
        {
            std::unique_lock<std::mutex> lk(s->m);
            s->cv_work.wait(lk, [&] { return !s->queue.empty() || s->closing; });
            if (s->queue.empty()) break;        // closing, and drained
            it = s->queue.front();
            s->queue.pop_front();
        }
        int64_t convert_ns = 0;
        if (!s->io_error.load()) {
            const void *out = it.iq;
            if (!_port_borrows(s)) {
                if (s->scratch.size() < it.nbytes) s->scratch.resize(it.nbytes);
                int64_t t0 = _port_now_ns();
                rt_convert_iq(it.iq, it.pairs, s->scratch.data(), s->type,
                              s->complex_out);
                convert_ns = _port_now_ns() - t0;
                out = s->scratch.data();
            }
            if (fwrite(out, 1, it.nbytes, s->f) != it.nbytes)
                s->io_error.store(1);
        }
        {
            std::lock_guard<std::mutex> lk(s->m);
            s->counts[0] += convert_ns;
            s->in_flight -= it.nbytes;
            s->written.store(it.seq);
        }
        s->cv_room.notify_all();
    }
    if (fflush(s->f) != 0) s->io_error.store(1);
}

extern "C" {

// A sink writing `type` samples (complex, or I alone) to `path`, or to
// stdout for "-" or NULL; submits wait while `bound` bytes are in flight.
// NULL where the file cannot be opened.
rt_port_sink *rt_port_sink_open(const char *path, int type, int complex_out,
                                size_t bound) {
    rt_port_sink *s = new (std::nothrow) rt_port_sink;
    if (!s) return nullptr;
    if (path && strcmp(path, "-") != 0) {
        s->f = fopen(path, "wb");
        s->own_file = true;
        if (!s->f) {
            delete s;
            return nullptr;
        }
    } else {
        s->f = stdout;
    }
    s->type = type;
    s->complex_out = complex_out;
    s->bound = bound;
    s->writer = std::thread(_port_writer_main, s);
    return s;
}

// Queue `pairs` interleaved I/Q pairs at `iq` for the writer thread, once
// fewer than the bound's bytes are in flight (so one write past the bound
// is always admitted).  Returns the write's sequence number, or -1 after an
// IO error.
int64_t rt_port_sink_submit(rt_port_sink *s, const int16_t *iq,
                            size_t pairs) {
    size_t nbytes = (s->complex_out ? 2 : 1) * pairs * rt_type_size(s->type);
    int64_t seq;
    {
        std::unique_lock<std::mutex> lk(s->m);
        int64_t t0 = _port_now_ns();
        s->cv_room.wait(lk, [&] {
            return s->in_flight < s->bound || s->io_error.load();
        });
        s->counts[1] += _port_now_ns() - t0;
        if (s->io_error.load()) return -1;
        seq = s->next_seq++;
        s->queue.push_back({iq, pairs, nbytes, seq});
        s->in_flight += nbytes;
        s->counts[2] += (int64_t)nbytes;
        if ((int64_t)s->in_flight > s->counts[3]) s->counts[3] = (int64_t)s->in_flight;
        if (_port_borrows(s)) s->counts[4] += 1;
    }
    s->cv_work.notify_one();
    return seq;
}

// The sequence number of the last write written (0 before the first): the
// caller may drop every array up to it.
int64_t rt_port_sink_done(rt_port_sink *s) { return s->written.load(); }

// The counts into out[5]: ns converting, ns waiting for room, bytes in, the
// most bytes in flight, writes borrowed.
void rt_port_sink_counts(rt_port_sink *s, int64_t *out) {
    std::lock_guard<std::mutex> lk(s->m);
    for (int i = 0; i < 5; i++) out[i] = s->counts[i];
}

// Write out every queued array, join the writer, flush and close the file;
// the final counts into counts[5] where not NULL.  Returns 0, or -1 after
// an IO error.
long rt_port_sink_close(rt_port_sink *s, int64_t *counts) {
    {
        std::lock_guard<std::mutex> lk(s->m);
        s->closing = true;
    }
    s->cv_work.notify_one();
    if (s->writer.joinable()) s->writer.join();
    if (s->own_file && fclose(s->f) != 0) s->io_error.store(1);
    if (counts) rt_port_sink_counts(s, counts);
    long err = s->io_error.load();
    delete s;
    return err ? -1 : 0;
}

}  // extern "C"
