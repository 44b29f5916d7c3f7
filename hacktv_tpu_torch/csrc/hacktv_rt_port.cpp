// The port's native runtime: native/hacktv_rt.cpp as it is, found on the
// include path, and the file sink's write with its counts.  Built by
// hacktv_tpu_torch/runtime.py with g++ -I <the directory of hacktv_rt.cpp>.

#include "hacktv_rt.cpp"

#include <chrono>

static inline int64_t _port_now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

extern "C" {

// rt_file_sink_write, counted into counts[4] on the caller's thread:
// [0] += ns converting (rt_convert_iq), [1] += ns writing into the FIFO
// (rt_fifo_write: the copy, and any wait for room), [2] += bytes handed to
// the FIFO, [3] = the highest FIFO level seen just after a write.
// Returns 0 on success, -1 on IO error, as rt_file_sink_write does.
long rt_file_sink_write_counted(rt_file_sink *s, const int16_t *iq,
                                size_t samples, int64_t *counts) {
    size_t need = (s->complex_out ? 2 : 1) * samples * rt_type_size(s->type);
    if (s->conv.size() < need) s->conv.resize(need);
    int64_t t0 = _port_now_ns();
    size_t nb = rt_convert_iq(iq, samples, s->conv.data(), s->type, s->complex_out);
    int64_t t1 = _port_now_ns();
    long r = rt_fifo_write(s->fifo, s->conv.data(), nb);
    counts[0] += t1 - t0;
    counts[1] += _port_now_ns() - t1;
    if (r < 0) return -1;
    counts[2] += (int64_t)nb;
    {
        std::lock_guard<std::mutex> lk(s->fifo->m);
        if ((int64_t)s->fifo->len > counts[3]) counts[3] = (int64_t)s->fifo->len;
    }
    return s->io_error.load() ? -1 : 0;
}

}  // extern "C"
