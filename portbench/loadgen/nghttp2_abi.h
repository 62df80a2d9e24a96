// Minimal self-declared ABI for libnghttp2.so.14 (system runtime lib; no
// dev headers in this image). Only the stable public API surface the data
// plane uses is declared — these signatures/layouts have been frozen since
// nghttp2 1.0 (https://nghttp2.org/documentation/, MIT). The full HTTP/2
// state machine (framing, HPACK, flow control, PING/SETTINGS handling)
// lives in the library; loadgen.cpp builds its gRPC client on top.
#pragma once
#include <cstddef>
#include <cstdint>
#include <sys/types.h>

extern "C" {

typedef struct nghttp2_session nghttp2_session;
typedef struct nghttp2_session_callbacks nghttp2_session_callbacks;
typedef struct nghttp2_option nghttp2_option;

typedef struct {
    uint8_t *name;
    uint8_t *value;
    size_t namelen;
    size_t valuelen;
    uint8_t flags;
} nghttp2_nv;

typedef struct {
    size_t length;
    int32_t stream_id;
    uint8_t type;
    uint8_t flags;
    uint8_t reserved;
} nghttp2_frame_hd;

// nghttp2_frame is a union of per-type structs, every one of which starts
// with nghttp2_frame_hd — accessing only ->hd through this alias is
// layout-safe.
typedef struct {
    nghttp2_frame_hd hd;
} nghttp2_frame;

typedef union {
    int fd;
    void *ptr;
} nghttp2_data_source;

typedef ssize_t (*nghttp2_data_source_read_callback)(
    nghttp2_session *session, int32_t stream_id, uint8_t *buf, size_t length,
    uint32_t *data_flags, nghttp2_data_source *source, void *user_data);

typedef struct {
    nghttp2_data_source source;
    nghttp2_data_source_read_callback read_callback;
} nghttp2_data_provider;

typedef struct {
    int32_t settings_id;
    uint32_t value;
} nghttp2_settings_entry;

typedef struct {
    int32_t stream_id;
    int32_t weight;
    uint8_t exclusive;
} nghttp2_priority_spec;

enum {
    NGHTTP2_FLAG_NONE = 0,
    NGHTTP2_FLAG_END_STREAM = 0x01,
    NGHTTP2_FLAG_END_HEADERS = 0x04,
};

enum {
    NGHTTP2_DATA = 0,
    NGHTTP2_HEADERS = 1,
    NGHTTP2_RST_STREAM = 3,
    NGHTTP2_SETTINGS = 4,
    NGHTTP2_GOAWAY = 7,
};

enum {
    NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS = 3,
    NGHTTP2_SETTINGS_INITIAL_WINDOW_SIZE = 4,
    NGHTTP2_SETTINGS_MAX_FRAME_SIZE = 5,
};

enum {
    NGHTTP2_DATA_FLAG_NONE = 0,
    NGHTTP2_DATA_FLAG_EOF = 0x01,
    NGHTTP2_DATA_FLAG_NO_END_STREAM = 0x02,
};

enum {
    NGHTTP2_ERR_WOULDBLOCK = -504,
    NGHTTP2_ERR_DEFERRED = -508,
};

enum { NGHTTP2_NO_ERROR = 0, NGHTTP2_INTERNAL_ERROR = 2 };

typedef int (*nghttp2_on_frame_recv_callback)(nghttp2_session *,
                                              const nghttp2_frame *, void *);
typedef int (*nghttp2_on_begin_headers_callback)(nghttp2_session *,
                                                 const nghttp2_frame *,
                                                 void *);
typedef int (*nghttp2_on_header_callback)(nghttp2_session *,
                                          const nghttp2_frame *,
                                          const uint8_t *, size_t,
                                          const uint8_t *, size_t, uint8_t,
                                          void *);
typedef int (*nghttp2_on_data_chunk_recv_callback)(nghttp2_session *, uint8_t,
                                                   int32_t, const uint8_t *,
                                                   size_t, void *);
typedef int (*nghttp2_on_stream_close_callback)(nghttp2_session *, int32_t,
                                                uint32_t, void *);

int nghttp2_session_callbacks_new(nghttp2_session_callbacks **);
void nghttp2_session_callbacks_del(nghttp2_session_callbacks *);
void nghttp2_session_callbacks_set_on_frame_recv_callback(
    nghttp2_session_callbacks *, nghttp2_on_frame_recv_callback);
void nghttp2_session_callbacks_set_on_begin_headers_callback(
    nghttp2_session_callbacks *, nghttp2_on_begin_headers_callback);
void nghttp2_session_callbacks_set_on_header_callback(
    nghttp2_session_callbacks *, nghttp2_on_header_callback);
void nghttp2_session_callbacks_set_on_data_chunk_recv_callback(
    nghttp2_session_callbacks *, nghttp2_on_data_chunk_recv_callback);
void nghttp2_session_callbacks_set_on_stream_close_callback(
    nghttp2_session_callbacks *, nghttp2_on_stream_close_callback);

int nghttp2_session_server_new(nghttp2_session **,
                               const nghttp2_session_callbacks *, void *);
int nghttp2_session_client_new(nghttp2_session **,
                               const nghttp2_session_callbacks *, void *);
void nghttp2_session_del(nghttp2_session *);

ssize_t nghttp2_session_mem_recv(nghttp2_session *, const uint8_t *, size_t);
ssize_t nghttp2_session_mem_send(nghttp2_session *, const uint8_t **);
int nghttp2_session_want_read(nghttp2_session *);
int nghttp2_session_want_write(nghttp2_session *);

int nghttp2_submit_settings(nghttp2_session *, uint8_t,
                            const nghttp2_settings_entry *, size_t);
int nghttp2_submit_response(nghttp2_session *, int32_t, const nghttp2_nv *,
                            size_t, const nghttp2_data_provider *);
int nghttp2_submit_trailer(nghttp2_session *, int32_t, const nghttp2_nv *,
                           size_t);
int32_t nghttp2_submit_request(nghttp2_session *,
                               const nghttp2_priority_spec *,
                               const nghttp2_nv *, size_t,
                               const nghttp2_data_provider *, void *);
int nghttp2_submit_rst_stream(nghttp2_session *, uint8_t, int32_t, uint32_t);

void *nghttp2_session_get_stream_user_data(nghttp2_session *, int32_t);
int nghttp2_session_set_stream_user_data(nghttp2_session *, int32_t, void *);

}  // extern "C"
