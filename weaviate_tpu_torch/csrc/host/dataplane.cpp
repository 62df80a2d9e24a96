// Native gRPC serving data plane.
//
// The reference serves gRPC from Go handlers that scale with cores
// (adapters/handlers/grpc/server.go:50; scatter-gather at
// adapters/repos/db/index.go:1576). A Python front end caps this
// framework at ~1.2k QPS of fabric throughput regardless of device
// speed (~0.8 ms of GIL-bound host CPU per query, BASELINE r4). This
// file moves the per-query hot path out of the GIL entirely:
//
//   epoll net thread -> nghttp2 (HTTP/2 + HPACK, system libnghttp2)
//     -> gRPC message assembly -> fast-path SearchRequest proto parse
//     -> per-collection batch coalescing
//   Python dispatcher thread  <- dp_wait() (GIL released)
//     -> one jitted device dispatch per BATCH, not per query
//     -> dp_post_batch(): replies built in C++ from a docid->payload
//        cache (uuid + preencoded PropertiesResult), misses returned
//        to Python for a slow-path reply
//   everything that is not a plain nearVector Search (filters, hybrid,
//   tenants, BatchObjects, ...) is handed to Python as raw request
//   bytes and answered through the existing servicer logic.
//
// The same file carries the load-generator client (dp_bench): with one
// CPU core, a Python gRPC client would saturate long before the server
// does, so the bench harness drives the server with native streams.
//
// Python bindings: weaviate_tpu_torch/dataplane.py. The PyTorch port's
// own copy of the JAX package's csrc/dataplane.cpp: the same code.
//
// Build: weaviate_tpu_torch/dataplane.py runs g++ -O3 -fPIC -shared
// -std=c++17 at first use, into build/torch_native/, linking the system
// libnghttp2.so.14 (this file compiles against nghttp2_abi.h beside it,
// so no -dev package is needed).

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "nghttp2_abi.h"

namespace {

uint64_t now_us() {
    return (uint64_t)std::chrono::duration_cast<std::chrono::microseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

// ---- tiny protobuf helpers ------------------------------------------------

struct PbReader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    uint64_t varint() {
        uint64_t v = 0;
        int shift = 0;
        while (p < end) {
            uint8_t b = *p++;
            v |= (uint64_t)(b & 0x7f) << shift;
            if (!(b & 0x80)) return v;
            shift += 7;
            if (shift > 63) break;
        }
        ok = false;
        return 0;
    }
    bool skip(uint32_t wt) {
        switch (wt) {
            case 0: varint(); return ok;
            case 1: if (end - p < 8) return ok = false; p += 8; return true;
            case 2: {
                uint64_t n = varint();
                if (!ok || (uint64_t)(end - p) < n) return ok = false;
                p += n;
                return true;
            }
            case 5: if (end - p < 4) return ok = false; p += 4; return true;
            default: return ok = false;
        }
    }
};

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
void pb_f32(std::string& o, uint32_t field, float v) {
    pb_tag(o, field, 5);
    o.append((const char*)&v, 4);
}

// ---- shared state ---------------------------------------------------------

struct CacheEntry {
    std::string uuid;   // canonical 36-char form
    std::string props;  // preencoded PropertiesResult message bytes
};

struct Collection {
    std::string name;
    int32_t dim = 0;
    std::unordered_map<int64_t, CacheEntry> cache;
    std::shared_mutex mtx;
};

struct Stream;
struct Conn;

struct BatchQuery {
    uint64_t token;
    int32_t k;
};

struct PendingBatch {
    int32_t coll = -1;
    std::vector<BatchQuery> queries;
    std::vector<float> qbuf;
    uint64_t deadline_us = 0;
};

struct WorkItem {
    int kind;  // 1 = search batch, 2 = fallback request
    PendingBatch batch;
    uint64_t token = 0;       // fallback
    std::string method;       // fallback
    std::string payload;      // fallback (gRPC message, prefix stripped)
};

struct DoneItem {
    uint64_t token;
    std::string reply;  // full gRPC wire message(s): prefix + payload
    int grpc_status;
    std::string grpc_msg;
};

struct DP {
    // config
    int32_t max_batch = 128;
    uint32_t window_us = 700;

    int epfd = -1, listen_fd = -1, evfd = -1;
    int port = 0;
    std::atomic<bool> running{false};
    std::thread net;

    std::mutex reg_mtx;
    std::vector<Collection*> colls;

    // net-thread-owned
    std::unordered_map<uint64_t, Conn*> conns;
    uint64_t next_conn_id = 2;  // 0 = listen socket, 1 = eventfd sentinel
    std::unordered_map<uint64_t, std::pair<uint64_t, int32_t>> tokens;
    uint64_t next_token = 1;
    std::vector<PendingBatch> pending;  // per collection id

    // python-facing queues
    std::mutex q_mtx;
    std::condition_variable q_cv;
    std::deque<WorkItem*> py_q;
    std::deque<DoneItem*> done_q;
    std::atomic<uint64_t> served_fast{0}, served_fallback{0};
    // per-doc reply-cache accounting (dp_cache_stats): how much of the
    // hot path's property fetch is served without re-entering Python
    std::atomic<uint64_t> cache_hits{0}, cache_misses{0};
};

DP* g_dp = nullptr;
std::mutex g_pl_mtx;
std::unordered_map<uint64_t, std::string> g_payloads;

struct Stream {
    Conn* conn;
    int32_t id;
    std::string path;
    std::string body;
    bool complete = false;
    // reply
    std::string reply;
    size_t reply_off = 0;
    int grpc_status = 0;
    std::string grpc_msg;
    bool trailers_sent = false;
};

struct Conn {
    int fd = -1;
    uint64_t id = 0;
    nghttp2_session* sess = nullptr;
    std::string outbuf;
    bool epollout = false;
    std::unordered_map<int32_t, Stream*> streams;
};

// ---- server-side nghttp2 callbacks ---------------------------------------

int on_begin_headers(nghttp2_session* sess, const nghttp2_frame* frame,
                     void* user) {
    Conn* c = (Conn*)user;
    if (frame->hd.type != NGHTTP2_HEADERS) return 0;
    Stream* s = new Stream();
    s->conn = c;
    s->id = frame->hd.stream_id;
    c->streams[s->id] = s;
    nghttp2_session_set_stream_user_data(sess, s->id, s);
    return 0;
}

int on_header(nghttp2_session*, const nghttp2_frame* frame,
              const uint8_t* name, size_t namelen, const uint8_t* value,
              size_t valuelen, uint8_t, void* user) {
    Conn* c = (Conn*)user;
    auto it = c->streams.find(frame->hd.stream_id);
    if (it == c->streams.end()) return 0;
    if (namelen == 5 && std::memcmp(name, ":path", 5) == 0)
        it->second->path.assign((const char*)value, valuelen);
    return 0;
}

int on_data_chunk(nghttp2_session*, uint8_t, int32_t stream_id,
                  const uint8_t* data, size_t len, void* user) {
    Conn* c = (Conn*)user;
    auto it = c->streams.find(stream_id);
    if (it == c->streams.end()) return 0;
    if (it->second->body.size() + len > (100u << 20)) return 0;  // cap 100MB
    it->second->body.append((const char*)data, len);
    return 0;
}

int on_stream_close(nghttp2_session*, int32_t stream_id, uint32_t,
                    void* user) {
    Conn* c = (Conn*)user;
    auto it = c->streams.find(stream_id);
    if (it != c->streams.end()) {
        delete it->second;
        c->streams.erase(it);
    }
    return 0;
}

void handle_request(DP* dp, Conn* c, Stream* s);

int on_frame_recv(nghttp2_session*, const nghttp2_frame* frame, void* user) {
    Conn* c = (Conn*)user;
    if ((frame->hd.type == NGHTTP2_DATA ||
         frame->hd.type == NGHTTP2_HEADERS) &&
        (frame->hd.flags & NGHTTP2_FLAG_END_STREAM)) {
        auto it = c->streams.find(frame->hd.stream_id);
        if (it != c->streams.end() && !it->second->complete) {
            it->second->complete = true;
            handle_request(g_dp, c, it->second);
        }
    }
    return 0;
}

// data provider streaming a stream's reply then its trailers
ssize_t reply_read_cb(nghttp2_session* sess, int32_t stream_id, uint8_t* buf,
                      size_t length, uint32_t* flags, nghttp2_data_source*,
                      void*) {
    Stream* s =
        (Stream*)nghttp2_session_get_stream_user_data(sess, stream_id);
    if (s == nullptr) return NGHTTP2_ERR_DEFERRED;
    size_t left = s->reply.size() - s->reply_off;
    size_t n = left < length ? left : length;
    std::memcpy(buf, s->reply.data() + s->reply_off, n);
    s->reply_off += n;
    if (s->reply_off == s->reply.size()) {
        *flags |= NGHTTP2_DATA_FLAG_EOF | NGHTTP2_DATA_FLAG_NO_END_STREAM;
        char status[16];
        int sn = snprintf(status, sizeof status, "%d", s->grpc_status);
        nghttp2_nv trailers[2] = {
            {(uint8_t*)"grpc-status", (uint8_t*)status, 11, (size_t)sn, 0},
            {(uint8_t*)"grpc-message", (uint8_t*)s->grpc_msg.data(), 12,
             s->grpc_msg.size(), 0},
        };
        nghttp2_submit_trailer(sess, stream_id, trailers,
                               s->grpc_msg.empty() ? 1 : 2);
        s->trailers_sent = true;
    }
    return (ssize_t)n;
}

void submit_reply(DP*, Conn* c, Stream* s) {
    static const char kCT[] = "application/grpc";
    nghttp2_nv hdrs[2] = {
        {(uint8_t*)":status", (uint8_t*)"200", 7, 3, 0},
        {(uint8_t*)"content-type", (uint8_t*)kCT, 12, sizeof(kCT) - 1, 0},
    };
    nghttp2_data_provider prd;
    prd.source.ptr = s;
    prd.read_callback = reply_read_cb;
    nghttp2_submit_response(c->sess, s->id, hdrs, 2, &prd);
}

// wrap a serialized proto into one gRPC wire message
void grpc_wrap(std::string& out, const std::string& msg) {
    out.push_back(0);
    uint32_t n = (uint32_t)msg.size();
    uint8_t be[4] = {(uint8_t)(n >> 24), (uint8_t)(n >> 16), (uint8_t)(n >> 8),
                     (uint8_t)n};
    out.append((const char*)be, 4);
    out += msg;
}

// ---- request routing ------------------------------------------------------

// Parse the subset of SearchRequest the fast path serves. Returns false
// (-> Python fallback) on anything beyond: collection + near_vector
// {vector_bytes} + limit + metadata{uuid, distance, certainty} +
// uses_123_api/uses_125_api.
struct FastSearch {
    std::string collection;
    const uint8_t* vec = nullptr;
    size_t vec_len = 0;
    int32_t limit = 10;
    bool uses_123 = false;
    bool md_uuid = false, md_distance = false;
};

bool parse_fast_search(const uint8_t* p, size_t n, FastSearch* out) {
    PbReader r{p, p + n};
    while (r.p < r.end && r.ok) {
        uint64_t key = r.varint();
        if (!r.ok) return false;
        uint32_t field = (uint32_t)(key >> 3), wt = (uint32_t)(key & 7);
        switch (field) {
            case 1: {  // collection
                if (wt != 2) return false;
                uint64_t len = r.varint();
                if (!r.ok || (uint64_t)(r.end - r.p) < len) return false;
                out->collection.assign((const char*)r.p, len);
                r.p += len;
                break;
            }
            case 30: {  // limit
                if (wt != 0) return false;
                out->limit = (int32_t)r.varint();
                break;
            }
            case 43: {  // near_vector
                if (wt != 2) return false;
                uint64_t len = r.varint();
                if (!r.ok || (uint64_t)(r.end - r.p) < len) return false;
                PbReader nv{r.p, r.p + len};
                r.p += len;
                while (nv.p < nv.end && nv.ok) {
                    uint64_t k2 = nv.varint();
                    uint32_t f2 = (uint32_t)(k2 >> 3), w2 = (uint32_t)(k2 & 7);
                    if (f2 == 4 && w2 == 2) {  // vector_bytes
                        uint64_t vl = nv.varint();
                        if (!nv.ok || (uint64_t)(nv.end - nv.p) < vl)
                            return false;
                        out->vec = nv.p;
                        out->vec_len = vl;
                        nv.p += vl;
                    } else {
                        return false;  // certainty/distance/targets -> slow
                    }
                }
                if (!nv.ok) return false;
                break;
            }
            case 21: {  // metadata request
                if (wt != 2) return false;
                uint64_t len = r.varint();
                if (!r.ok || (uint64_t)(r.end - r.p) < len) return false;
                PbReader md{r.p, r.p + len};
                r.p += len;
                while (md.p < md.end && md.ok) {
                    uint64_t k2 = md.varint();
                    uint32_t f2 = (uint32_t)(k2 >> 3), w2 = (uint32_t)(k2 & 7);
                    if (w2 != 0) return false;
                    uint64_t v = md.varint();
                    // the fast reply carries EXACTLY id + distance; any
                    // other requested metadata -> slow path
                    if (f2 == 1) out->md_uuid = v != 0;
                    else if (f2 == 5) out->md_distance = v != 0;
                    else if (v) return false;
                }
                if (!md.ok) return false;
                break;
            }
            case 100:  // uses_123_api
                if (wt != 0) return false;
                out->uses_123 = r.varint() != 0;
                break;
            case 101:  // uses_125_api
                if (wt != 0) return false;
                r.varint();
                break;
            default:
                return false;  // any other feature -> Python
        }
    }
    return r.ok && !out->collection.empty() && out->vec != nullptr &&
           out->md_uuid && out->md_distance;
}

void queue_fallback(DP* dp, Conn* c, Stream* s) {
    uint64_t tok = dp->next_token++;
    dp->tokens[tok] = {c->id, s->id};
    WorkItem* w = new WorkItem();
    w->kind = 2;
    w->token = tok;
    w->method = s->path;
    // strip the 5-byte gRPC prefix (no compression support needed: the
    // channel is created without compression)
    if (s->body.size() >= 5)
        w->payload.assign(s->body.data() + 5, s->body.size() - 5);
    s->body.clear();
    {
        std::lock_guard<std::mutex> lk(dp->q_mtx);
        dp->py_q.push_back(w);
    }
    dp->q_cv.notify_one();
}

void flush_batch(DP* dp, int32_t coll_id) {
    PendingBatch& pb = dp->pending[coll_id];
    if (pb.queries.empty()) return;
    WorkItem* w = new WorkItem();
    w->kind = 1;
    w->batch.coll = coll_id;
    w->batch.queries.swap(pb.queries);
    w->batch.qbuf.swap(pb.qbuf);
    pb.deadline_us = 0;
    {
        std::lock_guard<std::mutex> lk(dp->q_mtx);
        dp->py_q.push_back(w);
    }
    dp->q_cv.notify_one();
}

void handle_request(DP* dp, Conn* c, Stream* s) {
    if (s->path == "/grpc.health.v1.Health/Check" ||
        s->path == "/grpc.health.v1.Health/Watch") {
        static const char kServing[] = {0x08, 0x01};
        std::string msg(kServing, 2);
        grpc_wrap(s->reply, msg);
        submit_reply(dp, c, s);
        return;
    }
    if (s->path == "/weaviate.v1.Weaviate/Search" && s->body.size() >= 5) {
        FastSearch fs;
        if (parse_fast_search((const uint8_t*)s->body.data() + 5,
                              s->body.size() - 5, &fs) &&
            fs.uses_123) {
            int32_t coll_id = -1, dim = 0;
            {
                std::lock_guard<std::mutex> lk(dp->reg_mtx);
                for (size_t i = 0; i < dp->colls.size(); ++i) {
                    if (dp->colls[i]->name == fs.collection) {
                        coll_id = (int32_t)i;
                        dim = dp->colls[i]->dim;
                        break;
                    }
                }
            }
            if (coll_id >= 0 && dim > 0 &&
                fs.vec_len == (size_t)dim * 4 && fs.limit > 0 &&
                fs.limit <= 1000) {
                uint64_t tok = dp->next_token++;
                dp->tokens[tok] = {c->id, s->id};
                if ((size_t)coll_id >= dp->pending.size())
                    dp->pending.resize(coll_id + 1);
                PendingBatch& pb = dp->pending[coll_id];
                if (pb.queries.empty())
                    pb.deadline_us = now_us() + dp->window_us;
                pb.coll = coll_id;
                pb.queries.push_back({tok, fs.limit});
                size_t off = pb.qbuf.size();
                pb.qbuf.resize(off + dim);
                std::memcpy(pb.qbuf.data() + off, fs.vec, (size_t)dim * 4);
                s->body.clear();
                if ((int32_t)pb.queries.size() >= dp->max_batch)
                    flush_batch(dp, coll_id);
                return;
            }
        }
    }
    queue_fallback(dp, c, s);
}

// ---- net thread -----------------------------------------------------------

void conn_flush(DP* dp, Conn* c) {
    // drain nghttp2's send queue into the conn buffer, then the socket
    for (;;) {
        const uint8_t* data = nullptr;
        ssize_t n = nghttp2_session_mem_send(c->sess, &data);
        if (n <= 0) break;
        c->outbuf.append((const char*)data, (size_t)n);
    }
    while (!c->outbuf.empty()) {
        ssize_t n = ::send(c->fd, c->outbuf.data(), c->outbuf.size(),
                           MSG_NOSIGNAL);
        if (n > 0) {
            c->outbuf.erase(0, (size_t)n);
        } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            break;
        } else {
            c->outbuf.clear();
            break;
        }
    }
    bool want = !c->outbuf.empty();
    if (want != c->epollout) {
        c->epollout = want;
        epoll_event ev{};
        ev.events = EPOLLIN | (want ? EPOLLOUT : 0);
        ev.data.u64 = c->id;
        epoll_ctl(dp->epfd, EPOLL_CTL_MOD, c->fd, &ev);
    }
}

void conn_close(DP* dp, Conn* c) {
    epoll_ctl(dp->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    ::close(c->fd);
    for (auto& kv : c->streams) delete kv.second;
    c->streams.clear();
    nghttp2_session_del(c->sess);
    dp->conns.erase(c->id);
    delete c;
}

void accept_conns(DP* dp) {
    for (;;) {
        int fd = ::accept4(dp->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
        if (fd < 0) break;
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        Conn* c = new Conn();
        c->fd = fd;
        c->id = dp->next_conn_id++;
        nghttp2_session_callbacks* cbs = nullptr;
        nghttp2_session_callbacks_new(&cbs);
        nghttp2_session_callbacks_set_on_begin_headers_callback(
            cbs, on_begin_headers);
        nghttp2_session_callbacks_set_on_header_callback(cbs, on_header);
        nghttp2_session_callbacks_set_on_data_chunk_recv_callback(
            cbs, on_data_chunk);
        nghttp2_session_callbacks_set_on_stream_close_callback(
            cbs, on_stream_close);
        nghttp2_session_callbacks_set_on_frame_recv_callback(cbs,
                                                             on_frame_recv);
        nghttp2_session_server_new(&c->sess, cbs, c);
        nghttp2_session_callbacks_del(cbs);
        nghttp2_settings_entry iv[2] = {
            {NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS, 1024},
            {NGHTTP2_SETTINGS_INITIAL_WINDOW_SIZE, 1 << 20},
        };
        nghttp2_submit_settings(c->sess, 0, iv, 2);
        dp->conns[c->id] = c;
        epoll_event ev{};
        ev.events = EPOLLIN;
        ev.data.u64 = c->id;
        epoll_ctl(dp->epfd, EPOLL_CTL_ADD, fd, &ev);
        conn_flush(dp, c);
    }
}

void drain_done(DP* dp) {
    std::deque<DoneItem*> items;
    {
        std::lock_guard<std::mutex> lk(dp->q_mtx);
        items.swap(dp->done_q);
    }
    for (DoneItem* d : items) {
        auto it = dp->tokens.find(d->token);
        if (it != dp->tokens.end()) {
            auto [conn_id, stream_id] = it->second;
            dp->tokens.erase(it);
            auto cit = dp->conns.find(conn_id);
            if (cit != dp->conns.end()) {
                Conn* c = cit->second;
                auto sit = c->streams.find(stream_id);
                if (sit != c->streams.end()) {
                    Stream* s = sit->second;
                    s->reply.swap(d->reply);
                    s->grpc_status = d->grpc_status;
                    s->grpc_msg.swap(d->grpc_msg);
                    submit_reply(dp, c, s);
                    conn_flush(dp, c);
                }
            }
        }
        delete d;
    }
}

void net_loop(DP* dp) {
    epoll_event evs[64];
    while (dp->running.load(std::memory_order_relaxed)) {
        // batching window: wake when the oldest pending batch expires
        int timeout = 200;
        uint64_t now = now_us();
        for (auto& pb : dp->pending) {
            if (pb.queries.empty()) continue;
            int64_t left_ms = ((int64_t)pb.deadline_us - (int64_t)now) / 1000;
            if (left_ms < 1) left_ms = 1;  // ms-resolution floor
            if (left_ms < timeout) timeout = (int)left_ms;
        }
        int n = epoll_wait(dp->epfd, evs, 64, timeout);
        now = now_us();
        for (size_t i = 0; i < dp->pending.size(); ++i) {
            if (!dp->pending[i].queries.empty() &&
                dp->pending[i].deadline_us <= now)
                flush_batch(dp, (int32_t)i);
        }
        for (int i = 0; i < n; ++i) {
            uint64_t id = evs[i].data.u64;
            if (id == 0) {  // listen socket
                accept_conns(dp);
                continue;
            }
            if (id == 1) {  // eventfd: completions from Python
                uint64_t junk;
                while (read(dp->evfd, &junk, 8) == 8) {}
                drain_done(dp);
                continue;
            }
            auto cit = dp->conns.find(id);
            if (cit == dp->conns.end()) continue;
            Conn* c = cit->second;
            bool dead = false;
            if (evs[i].events & (EPOLLHUP | EPOLLERR)) dead = true;
            if (!dead && (evs[i].events & EPOLLIN)) {
                char buf[65536];
                for (;;) {
                    ssize_t r = ::recv(c->fd, buf, sizeof buf, 0);
                    if (r > 0) {
                        ssize_t used = nghttp2_session_mem_recv(
                            c->sess, (const uint8_t*)buf, (size_t)r);
                        if (used < 0) { dead = true; break; }
                        // batched requests complete inside mem_recv via
                        // callbacks; responses queue inside the session
                    } else if (r == 0) {
                        dead = true;
                        break;
                    } else {
                        if (errno != EAGAIN && errno != EWOULDBLOCK)
                            dead = true;
                        break;
                    }
                }
            }
            if (!dead) {
                conn_flush(dp, c);
                if (!nghttp2_session_want_read(c->sess) &&
                    !nghttp2_session_want_write(c->sess))
                    dead = true;
            }
            if (dead) conn_close(dp, c);
        }
    }
    // shutdown: close everything
    std::vector<Conn*> cs;
    for (auto& kv : dp->conns) cs.push_back(kv.second);
    for (Conn* c : cs) conn_close(dp, c);
}

}  // namespace

// ---- C ABI ----------------------------------------------------------------

extern "C" {

// Start the data plane on `port` (0 = ephemeral). Returns the bound port
// or a negative errno.
int32_t dp_start(int32_t port, int32_t max_batch, int32_t window_us) {
    if (g_dp != nullptr) return -EALREADY;
    DP* dp = new DP();
    if (max_batch > 0) dp->max_batch = max_batch;
    if (window_us > 0) dp->window_us = (uint32_t)window_us;
    dp->listen_fd = ::socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    int one = 1;
    setsockopt(dp->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons((uint16_t)port);
    if (bind(dp->listen_fd, (sockaddr*)&addr, sizeof addr) != 0 ||
        listen(dp->listen_fd, 512) != 0) {
        int e = errno;
        ::close(dp->listen_fd);
        delete dp;
        return -e;
    }
    socklen_t alen = sizeof addr;
    getsockname(dp->listen_fd, (sockaddr*)&addr, &alen);
    dp->port = ntohs(addr.sin_port);
    dp->epfd = epoll_create1(0);
    dp->evfd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = 0;
    epoll_ctl(dp->epfd, EPOLL_CTL_ADD, dp->listen_fd, &ev);
    ev.data.u64 = 1;
    epoll_ctl(dp->epfd, EPOLL_CTL_ADD, dp->evfd, &ev);
    dp->running = true;
    g_dp = dp;
    dp->net = std::thread(net_loop, dp);
    return dp->port;
}

void dp_stop() {
    DP* dp = g_dp;
    if (dp == nullptr) return;
    dp->running = false;
    uint64_t one = 1;
    (void)!write(dp->evfd, &one, 8);
    dp->net.join();
    dp->q_cv.notify_all();
    ::close(dp->listen_fd);
    ::close(dp->epfd);
    ::close(dp->evfd);
    // leak dp->colls/queues intentionally: a dispatcher thread may still
    // be blocked in dp_wait; process teardown reclaims
    g_dp = nullptr;
}

int32_t dp_register_collection(const char* name, int32_t dim) {
    DP* dp = g_dp;
    if (dp == nullptr) return -1;
    std::lock_guard<std::mutex> lk(dp->reg_mtx);
    for (size_t i = 0; i < dp->colls.size(); ++i) {
        if (dp->colls[i]->name == name) {
            dp->colls[i]->dim = dim;
            return (int32_t)i;
        }
    }
    Collection* c = new Collection();
    c->name = name;
    c->dim = dim;
    dp->colls.push_back(c);
    return (int32_t)dp->colls.size() - 1;
}

// Bulk payload-cache upload: per doc i, uuid36[i] (36 bytes) and the
// preencoded PropertiesResult bytes props[poffs[i]:poffs[i+1]].
void dp_cache_put(int32_t coll_id, int64_t n, const int64_t* doc_ids,
                  const uint8_t* uuids36, const uint8_t* props,
                  const int64_t* poffs) {
    DP* dp = g_dp;
    if (dp == nullptr) return;
    Collection* c;
    {
        std::lock_guard<std::mutex> lk(dp->reg_mtx);
        if (coll_id < 0 || (size_t)coll_id >= dp->colls.size()) return;
        c = dp->colls[coll_id];
    }
    std::unique_lock<std::shared_mutex> lk(c->mtx);
    for (int64_t i = 0; i < n; ++i) {
        CacheEntry& e = c->cache[doc_ids[i]];
        e.uuid.assign((const char*)uuids36 + 36 * i, 36);
        e.props.assign((const char*)props + poffs[i],
                       (size_t)(poffs[i + 1] - poffs[i]));
    }
}

void dp_cache_clear(int32_t coll_id) {
    DP* dp = g_dp;
    if (dp == nullptr) return;
    Collection* c;
    {
        std::lock_guard<std::mutex> lk(dp->reg_mtx);
        if (coll_id < 0 || (size_t)coll_id >= dp->colls.size()) return;
        c = dp->colls[coll_id];
    }
    std::unique_lock<std::shared_mutex> lk(c->mtx);
    c->cache.clear();
}

// Wait for work. Returns: 0 timeout, 1 search batch, 2 fallback,
// 3 stopped. Batch: coll_id, count, tokens[], ks[], queries flattened
// into qbuf (caller-sized: max_batch * dim floats). Fallback: token,
// method (NUL-terminated into mbuf[mcap]), payload length in *plen —
// fetch with dp_fallback_payload.
int32_t dp_wait(int32_t timeout_ms, int32_t* coll_id, int64_t* count,
                uint64_t* tokens, int32_t* ks, float* qbuf, uint64_t* token,
                char* mbuf, int32_t mcap, int64_t* plen) {
    DP* dp = g_dp;
    if (dp == nullptr) return 3;
    WorkItem* w = nullptr;
    {
        std::unique_lock<std::mutex> lk(dp->q_mtx);
        if (!dp->q_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                               [&] {
                                   return !dp->py_q.empty() ||
                                          !dp->running.load();
                               }))
            return 0;
        if (dp->py_q.empty()) return dp->running.load() ? 0 : 3;
        w = dp->py_q.front();
        dp->py_q.pop_front();
    }
    if (w->kind == 1) {
        *coll_id = w->batch.coll;
        *count = (int64_t)w->batch.queries.size();
        for (size_t i = 0; i < w->batch.queries.size(); ++i) {
            tokens[i] = w->batch.queries[i].token;
            ks[i] = w->batch.queries[i].k;
        }
        std::memcpy(qbuf, w->batch.qbuf.data(),
                    w->batch.qbuf.size() * sizeof(float));
        delete w;
        return 1;
    }
    *token = w->token;
    snprintf(mbuf, (size_t)mcap, "%s", w->method.c_str());
    *plen = (int64_t)w->payload.size();
    {
        // park the payload for the follow-up dp_fallback_payload fetch
        std::lock_guard<std::mutex> lk(g_pl_mtx);
        g_payloads[w->token] = std::move(w->payload);
    }
    delete w;
    return 2;
}

// Copy (and drop) the parked fallback payload for `token`.
void dp_fallback_payload(uint64_t token, uint8_t* out) {
    std::lock_guard<std::mutex> lk(g_pl_mtx);
    auto it = g_payloads.find(token);
    if (it == g_payloads.end()) return;
    std::memcpy(out, it->second.data(), it->second.size());
    g_payloads.erase(it);
}

// Post a fallback reply: full serialized reply proto (C++ adds the gRPC
// prefix). status != 0 sends a trailers-only error.
void dp_post_raw(uint64_t token, const uint8_t* reply, int64_t reply_len,
                 int32_t grpc_status, const char* grpc_msg) {
    DP* dp = g_dp;
    if (dp == nullptr) return;
    DoneItem* d = new DoneItem();
    d->token = token;
    d->grpc_status = grpc_status;
    if (grpc_msg != nullptr) d->grpc_msg = grpc_msg;
    std::string msg((const char*)reply, (size_t)reply_len);
    grpc_wrap(d->reply, msg);
    {
        std::lock_guard<std::mutex> lk(dp->q_mtx);
        dp->done_q.push_back(d);
    }
    dp->served_fallback.fetch_add(1, std::memory_order_relaxed);
    uint64_t one = 1;
    (void)!write(dp->evfd, &one, 8);
}

// Post search-batch results. ids/dists are [count, kmax]; ncand[i] gives
// query i's valid prefix. Queries whose docids all hit the payload cache
// get their SearchReply built here; cache misses are reported back via
// miss_tokens (caller-sized >= count) and the caller replies through
// dp_post_raw. Returns the number of misses.
int64_t dp_post_batch(int32_t coll_id, int64_t count,
                      const uint64_t* tokens, const int32_t* ks,
                      int64_t kmax, const int64_t* ids, const float* dists,
                      const int64_t* ncand, float took_s,
                      uint64_t* miss_tokens) {
    DP* dp = g_dp;
    if (dp == nullptr) return 0;
    Collection* c;
    {
        std::lock_guard<std::mutex> lk(dp->reg_mtx);
        if (coll_id < 0 || (size_t)coll_id >= dp->colls.size()) return 0;
        c = dp->colls[coll_id];
    }
    int64_t misses = 0;
    uint64_t doc_hits = 0, doc_misses = 0;
    std::shared_lock<std::shared_mutex> lk(c->mtx);
    std::string result, meta, msg;
    std::deque<DoneItem*> done;
    for (int64_t i = 0; i < count; ++i) {
        int64_t n = ncand[i] < (int64_t)ks[i] ? ncand[i] : (int64_t)ks[i];
        msg.clear();
        pb_f32(msg, 1, took_s);
        bool miss = false;
        for (int64_t j = 0; j < n; ++j) {
            int64_t doc = ids[i * kmax + j];
            if (doc < 0) continue;
            auto it = c->cache.find(doc);
            if (it == c->cache.end()) {
                doc_misses++;
                miss = true;
                break;
            }
            doc_hits++;
            const CacheEntry& e = it->second;
            meta.clear();
            pb_len(meta, 1, e.uuid.data(), e.uuid.size());  // id
            pb_f32(meta, 7, dists[i * kmax + j]);           // distance
            pb_tag(meta, 8, 0);
            meta.push_back(1);  // distance_present
            result.clear();
            if (!e.props.empty())
                pb_len(result, 1, e.props.data(), e.props.size());
            pb_len(result, 2, meta.data(), meta.size());
            pb_len(msg, 2, result.data(), result.size());
        }
        if (miss) {
            miss_tokens[misses++] = tokens[i];
            continue;
        }
        DoneItem* d = new DoneItem();
        d->token = tokens[i];
        d->grpc_status = 0;
        grpc_wrap(d->reply, msg);
        done.push_back(d);
    }
    lk.unlock();
    if (!done.empty()) {
        std::lock_guard<std::mutex> qlk(dp->q_mtx);
        for (DoneItem* d : done) dp->done_q.push_back(d);
    }
    dp->cache_hits.fetch_add(doc_hits, std::memory_order_relaxed);
    dp->cache_misses.fetch_add(doc_misses, std::memory_order_relaxed);
    dp->served_fast.fetch_add((uint64_t)(count - misses),
                              std::memory_order_relaxed);
    uint64_t one = 1;
    (void)!write(dp->evfd, &one, 8);
    return misses;
}

// test hook: run the fast-path parser over a serialized SearchRequest.
// Returns 1 when the fast path would accept it, 0 otherwise; fills
// limit/dim_bytes when parsed.
int32_t dp_test_parse(const uint8_t* p, int64_t n, int32_t* limit,
                      int64_t* vec_bytes, int32_t* uses_123) {
    FastSearch fs;
    int ok = parse_fast_search(p, (size_t)n, &fs) ? 1 : 0;
    *limit = fs.limit;
    *vec_bytes = (int64_t)fs.vec_len;
    *uses_123 = fs.uses_123 ? 1 : 0;
    return ok;
}

void dp_stats(uint64_t* fast, uint64_t* fallback) {
    DP* dp = g_dp;
    if (dp == nullptr) { *fast = *fallback = 0; return; }
    *fast = dp->served_fast.load();
    *fallback = dp->served_fallback.load();
}

// Reply-cache accounting: `entries` = docs cached for coll_id (-1 = all
// collections), hits/misses = per-doc lookups across dp_post_batch
// calls. A hot path fully fed from the LSM-warmed cache shows
// misses == 0 after the warm pass.
void dp_cache_stats(int32_t coll_id, int64_t* entries, uint64_t* hits,
                    uint64_t* misses) {
    DP* dp = g_dp;
    *entries = 0;
    if (dp == nullptr) { *hits = *misses = 0; return; }
    {
        std::lock_guard<std::mutex> lk(dp->reg_mtx);
        for (size_t i = 0; i < dp->colls.size(); ++i) {
            if (coll_id >= 0 && (size_t)coll_id != i) continue;
            Collection* c = dp->colls[i];
            std::shared_lock<std::shared_mutex> clk(c->mtx);
            *entries += (int64_t)c->cache.size();
        }
    }
    *hits = dp->cache_hits.load();
    *misses = dp->cache_misses.load();
}

}  // extern "C"

// ---- load-generator client ------------------------------------------------
// With one CPU core, a Python gRPC client saturates at a fraction of the
// native server's throughput — the server must be driven by native
// streams to be measured honestly. One epoll loop in the calling thread
// (GIL released for the whole run), M connections × S pipelined streams.

namespace bench {

struct BStream {
    std::string body;  // full gRPC request message (prefixed)
    size_t off = 0;
    uint64_t t_start = 0;
};

struct BConn {
    int fd = -1;
    uint64_t id = 0;
    nghttp2_session* sess = nullptr;
    std::string outbuf;
    bool epollout = false;
    int inflight = 0;
};

struct BenchState {
    std::string authority;
    std::string request_proto_head;  // serialized SearchRequest minus vec
    int32_t dim = 10;
    int streams_per_conn = 8;
    uint64_t deadline_us = 0;
    uint64_t done = 0, errors = 0;
    std::vector<float> lat_ms;
    uint64_t rng = 0x9e3779b97f4a7c15ull;
    bool stopping = false;
    int epfd = -1;
    std::unordered_map<uint64_t, BConn*> conns;
};

uint64_t xorshift(BenchState* st) {
    uint64_t x = st->rng;
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    return st->rng = x;
}

ssize_t bench_read_cb(nghttp2_session* sess, int32_t stream_id, uint8_t* buf,
                      size_t length, uint32_t* flags, nghttp2_data_source*,
                      void*) {
    BStream* s =
        (BStream*)nghttp2_session_get_stream_user_data(sess, stream_id);
    if (s == nullptr) return 0;
    size_t left = s->body.size() - s->off;
    size_t n = left < length ? left : length;
    std::memcpy(buf, s->body.data() + s->off, n);
    s->off += n;
    if (s->off == s->body.size()) *flags |= NGHTTP2_DATA_FLAG_EOF;
    return (ssize_t)n;
}

void submit_query(BenchState* st, BConn* c) {
    BStream* s = new BStream();
    // SearchRequest = head + near_vector{vector_bytes=dim floats}
    std::string nv;
    std::string vec((size_t)st->dim * 4, '\0');
    float* f = (float*)vec.data();
    for (int i = 0; i < st->dim; ++i)
        f[i] = (float)((int64_t)(xorshift(st) & 0xffff) - 32768) / 16384.0f;
    pb_len(nv, 4, vec.data(), vec.size());
    std::string msg = st->request_proto_head;
    pb_len(msg, 43, nv.data(), nv.size());
    grpc_wrap(s->body, msg);
    s->t_start = now_us();
    static const char kPath[] = "/weaviate.v1.Weaviate/Search";
    nghttp2_nv hdrs[6] = {
        {(uint8_t*)":method", (uint8_t*)"POST", 7, 4, 0},
        {(uint8_t*)":scheme", (uint8_t*)"http", 7, 4, 0},
        {(uint8_t*)":path", (uint8_t*)kPath, 5, sizeof(kPath) - 1, 0},
        {(uint8_t*)":authority", (uint8_t*)st->authority.data(), 10,
         st->authority.size(), 0},
        {(uint8_t*)"content-type", (uint8_t*)"application/grpc", 12, 16, 0},
        {(uint8_t*)"te", (uint8_t*)"trailers", 2, 8, 0},
    };
    nghttp2_data_provider prd;
    prd.source.ptr = s;
    prd.read_callback = bench_read_cb;
    int32_t sid = nghttp2_submit_request(c->sess, nullptr, hdrs, 6, &prd, s);
    if (sid < 0) {
        delete s;
        return;
    }
    c->inflight++;
}

int bench_on_stream_close(nghttp2_session* sess, int32_t stream_id,
                          uint32_t error_code, void* user) {
    auto* pr = (std::pair<BenchState*, BConn*>*)user;
    BenchState* st = pr->first;
    BConn* c = pr->second;
    BStream* s =
        (BStream*)nghttp2_session_get_stream_user_data(sess, stream_id);
    if (s != nullptr) {
        if (error_code == 0) {
            st->done++;
            st->lat_ms.push_back((float)(now_us() - s->t_start) / 1000.0f);
        } else {
            st->errors++;
        }
        delete s;
    }
    c->inflight--;
    if (!st->stopping && now_us() < st->deadline_us) submit_query(st, c);
    return 0;
}

void bench_flush(BenchState* st, BConn* c) {
    for (;;) {
        const uint8_t* data = nullptr;
        ssize_t n = nghttp2_session_mem_send(c->sess, &data);
        if (n <= 0) break;
        c->outbuf.append((const char*)data, (size_t)n);
    }
    while (!c->outbuf.empty()) {
        ssize_t n = ::send(c->fd, c->outbuf.data(), c->outbuf.size(),
                           MSG_NOSIGNAL);
        if (n > 0) c->outbuf.erase(0, (size_t)n);
        else break;
    }
    bool want = !c->outbuf.empty();
    if (want != c->epollout) {
        c->epollout = want;
        epoll_event ev{};
        ev.events = EPOLLIN | (want ? EPOLLOUT : 0);
        ev.data.u64 = c->id;
        epoll_ctl(st->epfd, EPOLL_CTL_MOD, c->fd, &ev);
    }
}

}  // namespace bench

extern "C" {

// Drive `conns`×`streams` pipelined Search requests at 127.0.0.1:port for
// duration_ms. head/head_len: serialized SearchRequest WITHOUT the
// near_vector field (collection, limit, metadata, uses_123_api) — the
// caller builds it once with real protobuf. Returns completed count;
// fills qps/p50/p95/p99 (ms) and errors.
int64_t dp_bench(int32_t port, int32_t conns, int32_t streams,
                 int32_t duration_ms, int32_t dim, const uint8_t* head,
                 int64_t head_len, double* qps, float* p50, float* p95,
                 float* p99, int64_t* errors) {
    using namespace bench;
    BenchState st;
    st.dim = dim;
    st.streams_per_conn = streams;
    st.request_proto_head.assign((const char*)head, (size_t)head_len);
    char auth[32];
    snprintf(auth, sizeof auth, "127.0.0.1:%d", port);
    st.authority = auth;
    st.epfd = epoll_create1(0);
    std::vector<std::pair<BenchState*, BConn*>*> uds;
    for (int i = 0; i < conns; ++i) {
        int fd = ::socket(AF_INET, SOCK_STREAM, 0);
        sockaddr_in addr{};
        addr.sin_family = AF_INET;
        addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
        addr.sin_port = htons((uint16_t)port);
        if (connect(fd, (sockaddr*)&addr, sizeof addr) != 0) {
            ::close(fd);
            continue;
        }
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        // nonblocking AFTER the blocking connect: a full kernel send
        // buffer must EAGAIN (bench_flush buffers it), not stall the
        // generator's epoll loop and skew the measurement
        fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
        BConn* c = new BConn();
        c->fd = fd;
        c->id = (uint64_t)i + 1;
        auto* ud = new std::pair<BenchState*, BConn*>(&st, c);
        uds.push_back(ud);
        nghttp2_session_callbacks* cbs = nullptr;
        nghttp2_session_callbacks_new(&cbs);
        nghttp2_session_callbacks_set_on_stream_close_callback(
            cbs, bench_on_stream_close);
        nghttp2_session_client_new(&c->sess, cbs, ud);
        nghttp2_session_callbacks_del(cbs);
        nghttp2_settings_entry iv[1] = {
            {NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS, 1024}};
        nghttp2_submit_settings(c->sess, 0, iv, 1);
        st.conns[c->id] = c;
        epoll_event ev{};
        ev.events = EPOLLIN;
        ev.data.u64 = c->id;
        epoll_ctl(st.epfd, EPOLL_CTL_ADD, fd, &ev);
    }
    if (st.conns.empty()) {
        ::close(st.epfd);
        *qps = 0;
        return -1;
    }
    st.deadline_us = now_us() + (uint64_t)duration_ms * 1000;
    uint64_t t0 = now_us();
    for (auto& kv : st.conns) {
        for (int sidx = 0; sidx < streams; ++sidx)
            submit_query(&st, kv.second);
        bench_flush(&st, kv.second);
    }
    epoll_event evs[64];
    std::vector<char> buf(1 << 16);
    while (now_us() < st.deadline_us + 200000) {  // 200ms drain grace
        if (now_us() >= st.deadline_us) st.stopping = true;
        bool any_inflight = false;
        for (auto& kv : st.conns)
            if (kv.second->inflight > 0) any_inflight = true;
        if (st.stopping && !any_inflight) break;
        int n = epoll_wait(st.epfd, evs, 64, 50);
        for (int i = 0; i < n; ++i) {
            auto cit = st.conns.find(evs[i].data.u64);
            if (cit == st.conns.end()) continue;
            BConn* c = cit->second;
            if (evs[i].events & EPOLLIN) {
                ssize_t r = ::recv(c->fd, buf.data(), buf.size(),
                                   MSG_DONTWAIT);
                while (r > 0) {
                    nghttp2_session_mem_recv(c->sess, (const uint8_t*)buf.data(),
                                             (size_t)r);
                    r = ::recv(c->fd, buf.data(), buf.size(), MSG_DONTWAIT);
                }
            }
            bench_flush(&st, c);
        }
    }
    uint64_t t1 = now_us();
    for (auto& kv : st.conns) {
        nghttp2_session_del(kv.second->sess);
        ::close(kv.second->fd);
        delete kv.second;
    }
    for (auto* ud : uds) delete ud;
    ::close(st.epfd);
    std::sort(st.lat_ms.begin(), st.lat_ms.end());
    auto pct = [&](double q) -> float {
        if (st.lat_ms.empty()) return 0.0f;
        size_t i = (size_t)(q * (st.lat_ms.size() - 1));
        return st.lat_ms[i];
    };
    *qps = (double)st.done / ((double)(t1 - t0) / 1e6);
    *p50 = pct(0.50);
    *p95 = pct(0.95);
    *p99 = pct(0.99);
    *errors = (int64_t)st.errors;
    return (int64_t)st.done;
}

}  // extern "C"
