// The benchmark's gRPC load generator: closed-loop nearVector Search
// requests over native HTTP/2 streams, one process of its own.
//
// A copy of the port's dp_bench (weaviate_tpu_torch/csrc/host/
// dataplane.cpp), made a program and extended: it replays a query set
// (cycled in file order) instead of random vectors, records every
// request's send and reply times, reads each reply's grpc-status and
// decodes each SearchReply's (uuid, distance) list. Replies are kept per
// query as the distinct lists of uuids seen, each with the number of
// replies that gave it and, position by position, the least and the
// greatest distance any of them gave (the last bits of a distance may
// differ with the batch a query shared), so that every reply of the
// window can be judged without writing every reply to disk. A reply whose
// distances fall, or are not numbers, is counted as it comes.
//
//   loadgen --port P --conns C --streams S --seconds T --dim D
//           --queries FILE --head FILE [--out PREFIX] [--drain-s 60]
//           [--warmup-s W]
//
// With --warmup-s the loop runs W seconds before the window opens, without
// a pause between: the window starts on the loop's steady state. Times are
// taken from the window's start (a warm-up request's send time is below 0);
// every request's reply is kept and judged, the warm-up's too.
//
// Each of the C x S clients sends its next request as soon as its reply
// has come (a closed loop, as VectorDBBench's concurrency test runs).
//
// FILE of --queries: float32 [n, D]; --head: a serialized SearchRequest
// without its near_vector (collection, limit, metadata, filters), to
// which each request appends near_vector.vector_bytes. With --out it
// writes PREFIX.lat (per request: u32 query, i32 status, i64 send ns,
// i64 reply ns, reply -1 when none came) and PREFIX.ans (per distinct
// answer: u32 query, u32 count, u32 n, then n x (36-byte uuid, f32 least
// distance, f32 greatest distance)). Status 0 is a reply with grpc-status 0; a gRPC status code
// otherwise; 1000 + the HTTP/2 error code of a reset stream; 2001 no
// grpc-status; 2002 a reply that does not decode; 3000 no reply within
// --drain-s of the window's end; 3001 a connection lost. One JSON line
// on stdout sums it up (t0_ns: the start on CLOCK_MONOTONIC).
//
// Build: g++ -O2 -std=c++17 loadgen.cpp -o loadgen -l:libnghttp2.so.14
// (nghttp2_abi.h beside it declares the library's stable ABI).

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "nghttp2_abi.h"

namespace {

constexpr int MAX_VARIANTS = 64;  // distinct answers kept a query

int64_t now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

void pb_tag(std::string& o, uint32_t field, uint32_t wt) {
    uint32_t v = (field << 3) | wt;
    while (v >= 0x80) { o.push_back((char)(v | 0x80)); v >>= 7; }
    o.push_back((char)v);
}
void pb_varint(std::string& o, uint64_t v) {
    while (v >= 0x80) { o.push_back((char)(v | 0x80)); v >>= 7; }
    o.push_back((char)v);
}
void pb_len(std::string& o, uint32_t field, const void* data, size_t n) {
    pb_tag(o, field, 2);
    pb_varint(o, n);
    o.append((const char*)data, n);
}

struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;
    uint64_t varint() {
        uint64_t v = 0;
        for (int shift = 0; p < end && shift < 64; shift += 7) {
            uint8_t b = *p++;
            v |= (uint64_t)(b & 0x7f) << shift;
            if (!(b & 0x80)) return v;
        }
        ok = false;
        return 0;
    }
    // next field: returns false at the end or on a malformed message
    bool next(uint32_t* field, uint32_t* wt, const uint8_t** data, uint64_t* len) {
        if (p >= end || !ok) return false;
        uint64_t tag = varint();
        if (!ok) return false;
        *field = (uint32_t)(tag >> 3);
        *wt = (uint32_t)(tag & 7);
        switch (*wt) {
            case 0: *len = varint(); *data = nullptr; return ok;
            case 1: if (end - p < 8) return ok = false; *data = p; *len = 8; p += 8; return true;
            case 2: {
                uint64_t n = varint();
                if (!ok || (uint64_t)(end - p) < n) return ok = false;
                *data = p; *len = n; p += n; return true;
            }
            case 5: if (end - p < 4) return ok = false; *data = p; *len = 4; p += 4; return true;
            default: return ok = false;
        }
    }
};

struct Result {
    char uuid[36];
    float dist;
};

// SearchReply: results = 2 (SearchResult: metadata = 2 (MetadataResult:
// id = 1, distance = 7)). False when the message does not decode.
bool decode_reply(const std::string& body, std::vector<Result>* out) {
    if (body.size() < 5 || body[0] != 0) return false;
    uint32_t n = ((uint8_t)body[1] << 24) | ((uint8_t)body[2] << 16) |
                 ((uint8_t)body[3] << 8) | (uint8_t)body[4];
    if (body.size() != 5 + (size_t)n) return false;
    Reader r{(const uint8_t*)body.data() + 5, (const uint8_t*)body.data() + body.size()};
    uint32_t f, wt;
    const uint8_t* d;
    uint64_t len;
    while (r.next(&f, &wt, &d, &len)) {
        if (f != 2 || wt != 2) continue;
        Reader res{d, d + len};
        Result one{};
        bool have_id = false, have_dist = false;
        while (res.next(&f, &wt, &d, &len)) {
            if (f != 2 || wt != 2) continue;
            Reader meta{d, d + len};
            while (meta.next(&f, &wt, &d, &len)) {
                if (f == 1 && wt == 2 && len == 36) {
                    std::memcpy(one.uuid, d, 36);
                    have_id = true;
                } else if (f == 7 && wt == 5) {
                    std::memcpy(&one.dist, d, 4);
                    have_dist = true;
                }
            }
            if (!meta.ok) return false;
        }
        if (!res.ok || !have_id || !have_dist) return false;
        out->push_back(one);
    }
    return r.ok;
}

uint64_t hash_uuids(const std::vector<Result>& v) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a over the uuids
    for (const Result& x : v) {
        for (size_t i = 0; i < sizeof x.uuid; ++i) {
            h ^= (uint8_t)x.uuid[i];
            h *= 1099511628211ull;
        }
    }
    return h;
}

bool same_uuids(const std::vector<Result>& a, const std::vector<Result>& b) {
    if (a.size() != b.size()) return false;
    for (size_t i = 0; i < a.size(); ++i)
        if (std::memcmp(a[i].uuid, b[i].uuid, sizeof a[i].uuid) != 0) return false;
    return true;
}

struct Kept {
    char uuid[36];
    float dmin, dmax;
};

struct Variant {
    uint64_t hash;
    uint32_t count;
    std::vector<Result> results;  // the first reply's
    std::vector<float> dmin, dmax;
};

struct LatRec {
    uint32_t query;
    int32_t status;
    int64_t t_send;
    int64_t t_done;
};

struct Stream {
    std::string body;  // the gRPC request message
    size_t off = 0;
    std::string reply;
    int grpc_status = -1;
    uint32_t query = 0;
    int32_t sid = -1;
    int64_t t_send = 0;
};

struct Conn {
    int fd = -1;
    uint64_t id = 0;
    nghttp2_session* sess = nullptr;
    std::string outbuf;
    bool epollout = false;
    bool dead = false;
    std::unordered_set<Stream*> open;
};

struct State {
    std::string authority;
    std::string head;
    const float* queries = nullptr;
    uint32_t n_queries = 0;
    int32_t dim = 0;
    uint64_t next_query = 0;
    int64_t t0 = 0, deadline = 0, last_done = 0;  // t0: the window's start
    bool stopping = false;
    int epfd = -1;
    std::unordered_map<uint64_t, Conn*> conns;
    std::vector<LatRec> lat;
    std::vector<std::vector<Variant>> variants;
    uint64_t overflow = 0;
    uint64_t unordered = 0;  // replies whose distances fall or are NaN
    uint64_t sent = 0;
    // clients whose reply has come, by connection id, to send again
    std::vector<uint64_t> ready;
};

State g;

ssize_t read_cb(nghttp2_session* sess, int32_t stream_id, uint8_t* buf,
                size_t length, uint32_t* flags, nghttp2_data_source*, void*) {
    Stream* s = (Stream*)nghttp2_session_get_stream_user_data(sess, stream_id);
    if (s == nullptr) return 0;
    size_t left = s->body.size() - s->off;
    size_t n = left < length ? left : length;
    std::memcpy(buf, s->body.data() + s->off, n);
    s->off += n;
    if (s->off == s->body.size()) *flags |= NGHTTP2_DATA_FLAG_EOF;
    return (ssize_t)n;
}

void submit(Conn* c) {
    Stream* s = new Stream();
    s->query = (uint32_t)(g.next_query++ % g.n_queries);
    std::string nv;
    pb_len(nv, 4, g.queries + (size_t)s->query * g.dim, (size_t)g.dim * 4);
    std::string msg = g.head;
    pb_len(msg, 43, nv.data(), nv.size());
    s->body.push_back(0);
    uint32_t n = (uint32_t)msg.size();
    char be[4] = {(char)(n >> 24), (char)(n >> 16), (char)(n >> 8), (char)n};
    s->body.append(be, 4);
    s->body.append(msg);
    static const char kPath[] = "/weaviate.v1.Weaviate/Search";
    nghttp2_nv hdrs[6] = {
        {(uint8_t*)":method", (uint8_t*)"POST", 7, 4, 0},
        {(uint8_t*)":scheme", (uint8_t*)"http", 7, 4, 0},
        {(uint8_t*)":path", (uint8_t*)kPath, 5, sizeof(kPath) - 1, 0},
        {(uint8_t*)":authority", (uint8_t*)g.authority.data(), 10, g.authority.size(), 0},
        {(uint8_t*)"content-type", (uint8_t*)"application/grpc", 12, 16, 0},
        {(uint8_t*)"te", (uint8_t*)"trailers", 2, 8, 0},
    };
    nghttp2_data_provider prd;
    prd.source.ptr = s;
    prd.read_callback = read_cb;
    s->t_send = now_ns();
    int32_t sid = nghttp2_submit_request(c->sess, nullptr, hdrs, 6, &prd, s);
    if (sid < 0) {
        g.lat.push_back({s->query, 3001, s->t_send - g.t0, -1});
        delete s;
        return;
    }
    s->sid = sid;
    c->open.insert(s);
    g.sent++;
}

void record(Stream* s, int status) {
    int64_t t = now_ns();
    g.lat.push_back({s->query, status, s->t_send - g.t0, t - g.t0});
    if (t > g.last_done) g.last_done = t;
}

int on_header(nghttp2_session* sess, const nghttp2_frame* frame, const uint8_t* name,
              size_t namelen, const uint8_t* value, size_t valuelen, uint8_t, void*) {
    if (namelen != 11 || std::memcmp(name, "grpc-status", 11) != 0) return 0;
    Stream* s = (Stream*)nghttp2_session_get_stream_user_data(sess, frame->hd.stream_id);
    if (s != nullptr) s->grpc_status = atoi(std::string((const char*)value, valuelen).c_str());
    return 0;
}

int on_data(nghttp2_session* sess, uint8_t, int32_t stream_id, const uint8_t* data,
            size_t len, void*) {
    Stream* s = (Stream*)nghttp2_session_get_stream_user_data(sess, stream_id);
    if (s != nullptr) s->reply.append((const char*)data, len);
    return 0;
}

void keep_answer(Stream* s, std::vector<Result>&& res) {
    for (size_t i = 0; i < res.size(); ++i) {
        if (res[i].dist != res[i].dist || (i && res[i].dist < res[i - 1].dist)) {
            g.unordered++;
            break;
        }
    }
    uint64_t h = hash_uuids(res);
    std::vector<Variant>& vs = g.variants[s->query];
    for (Variant& v : vs) {
        if (v.hash == h && same_uuids(v.results, res)) {
            v.count++;
            for (size_t i = 0; i < res.size(); ++i) {
                if (res[i].dist < v.dmin[i] || res[i].dist != res[i].dist) v.dmin[i] = res[i].dist;
                if (res[i].dist > v.dmax[i] || res[i].dist != res[i].dist) v.dmax[i] = res[i].dist;
            }
            return;
        }
    }
    if ((int)vs.size() >= MAX_VARIANTS) {
        g.overflow++;
        return;
    }
    Variant v{h, 1, std::move(res), {}, {}};
    for (const Result& x : v.results) {
        v.dmin.push_back(x.dist);
        v.dmax.push_back(x.dist);
    }
    vs.push_back(std::move(v));
}

int on_close(nghttp2_session* sess, int32_t stream_id, uint32_t error_code, void* user) {
    Conn* c = (Conn*)user;
    Stream* s = (Stream*)nghttp2_session_get_stream_user_data(sess, stream_id);
    if (s == nullptr) return 0;
    c->open.erase(s);
    int status;
    std::vector<Result> res;
    if (error_code != 0) status = 1000 + (int)error_code;
    else if (s->grpc_status < 0) status = 2001;
    else if (s->grpc_status != 0) status = s->grpc_status;
    else if (!decode_reply(s->reply, &res)) status = 2002;
    else status = 0;
    record(s, status);
    if (status == 0) keep_answer(s, std::move(res));
    delete s;
    int64_t t = now_ns();
    if (!g.stopping && t < g.deadline) g.ready.push_back(c->id);
    return 0;
}

// streams left open: their user data is cleared before they are freed,
// so no later callback of the session can reach them
void drop_open(Conn* c, int status, bool timed) {
    for (Stream* s : c->open) {
        nghttp2_session_set_stream_user_data(c->sess, s->sid, nullptr);
        if (timed) record(s, status);
        else g.lat.push_back({s->query, status, s->t_send - g.t0, -1});
        delete s;
    }
    c->open.clear();
}

void kill_conn(Conn* c) {
    drop_open(c, 3001, true);
    c->dead = true;
    epoll_ctl(g.epfd, EPOLL_CTL_DEL, c->fd, nullptr);
}

void flush(Conn* c) {
    if (c->dead) return;
    for (;;) {
        const uint8_t* data = nullptr;
        ssize_t n = nghttp2_session_mem_send(c->sess, &data);
        if (n < 0) { kill_conn(c); return; }
        if (n == 0) break;
        c->outbuf.append((const char*)data, (size_t)n);
    }
    while (!c->outbuf.empty()) {
        ssize_t n = ::send(c->fd, c->outbuf.data(), c->outbuf.size(), MSG_NOSIGNAL);
        if (n > 0) c->outbuf.erase(0, (size_t)n);
        else break;
    }
    bool want = !c->outbuf.empty();
    if (want != c->epollout) {
        c->epollout = want;
        epoll_event ev{};
        ev.events = EPOLLIN | (want ? EPOLLOUT : 0);
        ev.data.u64 = c->id;
        epoll_ctl(g.epfd, EPOLL_CTL_MOD, c->fd, &ev);
    }
}

bool read_file(const char* path, std::string* out) {
    FILE* f = fopen(path, "rb");
    if (f == nullptr) return false;
    char buf[1 << 16];
    size_t n;
    while ((n = fread(buf, 1, sizeof buf, f)) > 0) out->append(buf, n);
    fclose(f);
    return true;
}

bool write_outputs(const std::string& prefix) {
    FILE* f = fopen((prefix + ".lat").c_str(), "wb");
    if (f == nullptr) return false;
    bool ok = fwrite(g.lat.data(), sizeof(LatRec), g.lat.size(), f) == g.lat.size();
    ok = (fclose(f) == 0) && ok;
    f = fopen((prefix + ".ans").c_str(), "wb");
    if (f == nullptr) return false;
    for (uint32_t q = 0; q < g.n_queries; ++q) {
        for (const Variant& v : g.variants[q]) {
            uint32_t hdr[3] = {q, v.count, (uint32_t)v.results.size()};
            ok = fwrite(hdr, 4, 3, f) == 3 && ok;
            std::vector<Kept> kept(v.results.size());
            for (size_t i = 0; i < kept.size(); ++i) {
                std::memcpy(kept[i].uuid, v.results[i].uuid, sizeof kept[i].uuid);
                kept[i].dmin = v.dmin[i];
                kept[i].dmax = v.dmax[i];
            }
            ok = fwrite(kept.data(), sizeof(Kept), kept.size(), f) == kept.size() && ok;
        }
    }
    return (fclose(f) == 0) && ok;
}

}  // namespace

int main(int argc, char** argv) {
    static_assert(sizeof(Result) == 40, "Result is 36 uuid bytes + f32");
    static_assert(sizeof(Kept) == 44, "Kept is 36 uuid bytes + 2 f32");
    static_assert(sizeof(LatRec) == 24, "LatRec layout");
    int port = 0, conns = 1, streams = 1, dim = 0;
    double seconds = 1, drain_s = 60, warmup_s = 0;
    const char *qpath = nullptr, *hpath = nullptr, *out = nullptr;
    for (int i = 1; i + 1 < argc; i += 2) {
        std::string k = argv[i];
        const char* v = argv[i + 1];
        if (k == "--port") port = atoi(v);
        else if (k == "--conns") conns = atoi(v);
        else if (k == "--streams") streams = atoi(v);
        else if (k == "--seconds") seconds = atof(v);
        else if (k == "--drain-s") drain_s = atof(v);
        else if (k == "--warmup-s") warmup_s = atof(v);
        else if (k == "--dim") dim = atoi(v);
        else if (k == "--queries") qpath = v;
        else if (k == "--head") hpath = v;
        else if (k == "--out") out = v;
        else { fprintf(stderr, "loadgen: unknown option %s\n", k.c_str()); return 2; }
    }
    std::string qbytes, head;
    if (port <= 0 || dim <= 0 || qpath == nullptr || hpath == nullptr ||
        !read_file(qpath, &qbytes) || !read_file(hpath, &head) ||
        qbytes.size() % ((size_t)dim * 4) != 0 || qbytes.empty()) {
        fprintf(stderr, "loadgen: bad arguments or input files\n");
        return 2;
    }
    g.queries = (const float*)qbytes.data();
    g.n_queries = (uint32_t)(qbytes.size() / ((size_t)dim * 4));
    g.dim = dim;
    g.head = head;
    g.variants.resize(g.n_queries);
    char auth[32];
    snprintf(auth, sizeof auth, "127.0.0.1:%d", port);
    g.authority = auth;
    g.epfd = epoll_create1(0);
    for (int i = 0; i < conns; ++i) {
        int fd = ::socket(AF_INET, SOCK_STREAM, 0);
        sockaddr_in addr{};
        addr.sin_family = AF_INET;
        addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
        addr.sin_port = htons((uint16_t)port);
        if (connect(fd, (sockaddr*)&addr, sizeof addr) != 0) {
            fprintf(stderr, "loadgen: connect to %s failed\n", auth);
            return 1;
        }
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        // nonblocking after the blocking connect: a full send buffer must
        // EAGAIN (flush keeps the rest), not stall the loop
        fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
        Conn* c = new Conn();
        c->fd = fd;
        c->id = (uint64_t)i + 1;
        nghttp2_session_callbacks* cbs = nullptr;
        nghttp2_session_callbacks_new(&cbs);
        nghttp2_session_callbacks_set_on_stream_close_callback(cbs, on_close);
        nghttp2_session_callbacks_set_on_header_callback(cbs, on_header);
        nghttp2_session_callbacks_set_on_data_chunk_recv_callback(cbs, on_data);
        nghttp2_session_client_new(&c->sess, cbs, c);
        nghttp2_session_callbacks_del(cbs);
        nghttp2_settings_entry iv[1] = {{NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS, 1024}};
        nghttp2_submit_settings(c->sess, 0, iv, 1);
        g.conns[c->id] = c;
        epoll_event ev{};
        ev.events = EPOLLIN;
        ev.data.u64 = c->id;
        epoll_ctl(g.epfd, EPOLL_CTL_ADD, fd, &ev);
    }
    int64_t start = now_ns();
    g.t0 = start + (int64_t)(warmup_s * 1e9);
    g.deadline = g.t0 + (int64_t)(seconds * 1e9);
    int64_t give_up = g.deadline + (int64_t)(drain_s * 1e9);
    // each client's first request, whatever the window's length
    for (auto& kv : g.conns) {
        for (int s = 0; s < streams; ++s) submit(kv.second);
        flush(kv.second);
    }
    epoll_event evs[64];
    std::vector<char> buf(1 << 16);
    for (;;) {
        int64_t t = now_ns();
        if (t >= g.deadline) g.stopping = true;
        // clients whose reply has come send again (until the window closes)
        std::unordered_set<Conn*> sent_on;
        if (!g.stopping)
            for (uint64_t id : g.ready) {
                Conn* c = g.conns[id];
                if (c->dead) continue;
                submit(c);
                sent_on.insert(c);
            }
        g.ready.clear();
        for (Conn* c : sent_on) flush(c);
        bool any_open = false;
        for (auto& kv : g.conns)
            if (!kv.second->open.empty()) any_open = true;
        if ((g.stopping && !any_open) || t >= give_up) break;
        int timeout = 20;
        int n = epoll_wait(g.epfd, evs, 64, timeout);
        for (int i = 0; i < n; ++i) {
            auto it = g.conns.find(evs[i].data.u64);
            if (it == g.conns.end() || it->second->dead) continue;
            Conn* c = it->second;
            if (evs[i].events & (EPOLLIN | EPOLLHUP | EPOLLERR)) {
                for (;;) {
                    ssize_t r = ::recv(c->fd, buf.data(), buf.size(), MSG_DONTWAIT);
                    if (r > 0) {
                        if (nghttp2_session_mem_recv(c->sess, (const uint8_t*)buf.data(),
                                                     (size_t)r) < 0) {
                            kill_conn(c);
                            break;
                        }
                    } else {
                        if (r == 0) kill_conn(c);
                        break;
                    }
                }
            }
            flush(c);
        }
    }
    uint64_t unanswered = 0;
    for (auto& kv : g.conns) {
        Conn* c = kv.second;
        unanswered += c->open.size();
        drop_open(c, 3000, false);
        nghttp2_session_del(c->sess);
        ::close(c->fd);
        delete c;
    }
    ::close(g.epfd);
    uint64_t ok = 0, variants = 0;
    for (const LatRec& r : g.lat) ok += r.status == 0;
    for (const auto& vs : g.variants) variants += vs.size();
    if (out != nullptr && !write_outputs(out)) {
        fprintf(stderr, "loadgen: writing %s.* failed\n", out);
        return 1;
    }
    printf("{\"t0_ns\": %lld, \"sent\": %llu, \"ok\": %llu, \"records\": %zu, \"unanswered\": %llu, "
           "\"window_s\": %.9f, \"variants\": %llu, \"overflow\": %llu, \"unordered\": %llu}\n",
           (long long)g.t0, (unsigned long long)g.sent, (unsigned long long)ok, g.lat.size(),
           (unsigned long long)unanswered,
           (double)((g.last_done > g.t0 ? g.last_done : now_ns()) - g.t0) / 1e9,
           (unsigned long long)variants, (unsigned long long)g.overflow,
           (unsigned long long)g.unordered);
    return 0;
}
