// Native FAST5 (HDF5) reader of the PHASE A ingest worker processes
// (pipeline/ingest.py, bound by fast5_native.py): a read's metadata
// attributes, raw DAC signal and albacore basecall summary and event
// columns through the HDF5 C API, one C call per logical operation, in
// place of h5py's per-object Python proxies. Host code only; built with
// g++ at first use, not with nvcc.
//
// This is poreplex-tpu's src/fast5_ingest.cc with one change:
// f5i_list_children separates the names with NUL, not newline, since an
// HDF5 link name may hold a newline.
//
// libhdf5 is resolved at RUN TIME with dlopen/dlsym (no HDF5 headers are
// needed; the C API prototypes below are declared by hand against the
// stable public ABI, hid_t being int64_t since 1.10). f5i_init() must be
// called first with a candidate library path (the Python side tries the
// system libhdf5_serial, then h5py's bundled copy); every entry point
// degrades to an error code that the Python caller turns into a read
// through h5py.
//
// The pA conversion is NOT done here: the integer DAC stays integer up
// to the device (pipeline/read.py dac_window).

#include <dlfcn.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>
#include <stdio.h>
#include <stdlib.h>

extern "C" {

typedef int64_t hid_t;
typedef uint64_t hsize_t;
typedef int herr_t;
typedef int htri_t;
typedef size_t hsizet;

// ---- resolved HDF5 entry points ----------------------------------------
static void* h5lib = nullptr;

#define H5FN(ret, name, args) static ret (*p_##name) args = nullptr;
H5FN(herr_t, H5open, (void))
H5FN(herr_t, H5Eset_auto2, (hid_t, void*, void*))
H5FN(hid_t, H5Fopen, (const char*, unsigned, hid_t))
H5FN(herr_t, H5Fclose, (hid_t))
H5FN(hid_t, H5Oopen, (hid_t, const char*, hid_t))
H5FN(herr_t, H5Oclose, (hid_t))
H5FN(hid_t, H5Aopen, (hid_t, const char*, hid_t))
H5FN(htri_t, H5Aexists, (hid_t, const char*))
H5FN(herr_t, H5Aread, (hid_t, hid_t, void*))
H5FN(hid_t, H5Aget_type, (hid_t))
H5FN(herr_t, H5Aclose, (hid_t))
H5FN(hid_t, H5Dopen2, (hid_t, const char*, hid_t))
H5FN(herr_t, H5Dclose, (hid_t))
H5FN(herr_t, H5Dread, (hid_t, hid_t, hid_t, hid_t, hid_t, void*))
H5FN(hid_t, H5Dget_type, (hid_t))
H5FN(hid_t, H5Dget_space, (hid_t))
H5FN(herr_t, H5Sclose, (hid_t))
H5FN(int64_t, H5Sget_simple_extent_npoints, (hid_t))
H5FN(hid_t, H5Tcopy, (hid_t))
H5FN(hid_t, H5Tcreate, (int, size_t))
H5FN(herr_t, H5Tinsert, (hid_t, const char*, size_t, hid_t))
H5FN(herr_t, H5Tclose, (hid_t))
H5FN(herr_t, H5Tset_size, (hid_t, size_t))
H5FN(size_t, H5Tget_size, (hid_t))
H5FN(htri_t, H5Tis_variable_str, (hid_t))
H5FN(int, H5Tget_class, (hid_t))
H5FN(int, H5Tget_member_index, (hid_t, const char*))
H5FN(int, H5Tget_nmembers, (hid_t))
H5FN(hid_t, H5Tget_member_type, (hid_t, unsigned))
H5FN(htri_t, H5Lexists, (hid_t, const char*, hid_t))
H5FN(int64_t, H5Lget_name_by_idx,
     (hid_t, const char*, int, int, hsize_t, char*, size_t, hid_t))
H5FN(herr_t, H5free_memory, (void*))
#undef H5FN

// native type globals (macro-backed global hid_t variables in the ABI)
static hid_t T_DOUBLE = -1, T_LLONG = -1, T_ULLONG = -1, T_INT16 = -1,
             T_C_S1 = -1;

static const unsigned H5F_ACC_RDONLY_ = 0u;
static const hid_t P_DEFAULT = 0;
static const hid_t S_ALL = 0;
static const int T_COMPOUND_ = 6;   // H5T_class_t::H5T_COMPOUND
static const int T_STRING_ = 3;     // H5T_class_t::H5T_STRING
static const size_t T_VARIABLE_ = (size_t)-1;

static int resolve(void* lib, const char* name, void** slot) {
    *slot = dlsym(lib, name);
    return *slot != nullptr;
}

int f5i_init(const char* libpath) {
    if (h5lib) return 0;
    void* lib = dlopen(libpath, RTLD_NOW | RTLD_LOCAL);
    if (!lib) return -1;
    int ok = 1;
#define R(name) ok &= resolve(lib, #name, (void**)&p_##name);
    R(H5open) R(H5Eset_auto2) R(H5Fopen) R(H5Fclose) R(H5Oopen) R(H5Oclose)
    R(H5Aopen) R(H5Aexists) R(H5Aread) R(H5Aget_type) R(H5Aclose)
    R(H5Dopen2) R(H5Dclose) R(H5Dread) R(H5Dget_type) R(H5Dget_space)
    R(H5Sclose) R(H5Sget_simple_extent_npoints) R(H5Tcopy) R(H5Tcreate)
    R(H5Tinsert) R(H5Tclose) R(H5Tset_size) R(H5Tget_size)
    R(H5Tis_variable_str) R(H5Tget_class) R(H5Tget_member_index)
    R(H5Tget_nmembers) R(H5Tget_member_type) R(H5Lexists)
    R(H5Lget_name_by_idx) R(H5free_memory)
#undef R
    if (!ok) { dlclose(lib); return -2; }
    hid_t* g;
#define G(sym, dst) \
    g = (hid_t*)dlsym(lib, sym); if (!g) { dlclose(lib); return -3; } dst = g;
    hid_t *gd, *gl, *gu, *gi, *gs;
    G("H5T_NATIVE_DOUBLE_g", gd) G("H5T_NATIVE_LLONG_g", gl)
    G("H5T_NATIVE_ULLONG_g", gu) G("H5T_NATIVE_INT16_g", gi)
    G("H5T_C_S1_g", gs)
#undef G
    if (p_H5open() < 0) { dlclose(lib); return -4; }
    p_H5Eset_auto2(0, nullptr, nullptr);   // silence the error stack
    T_DOUBLE = *gd; T_LLONG = *gl; T_ULLONG = *gu; T_INT16 = *gi;
    T_C_S1 = *gs;
    h5lib = lib;
    return 0;
}

int f5i_available(void) { return h5lib != nullptr; }

int64_t f5i_open(const char* path) {
    if (!h5lib) return -1;
    return (int64_t)p_H5Fopen(path, H5F_ACC_RDONLY_, P_DEFAULT);
}

int f5i_close(int64_t fid) {
    if (!h5lib) return -1;
    return p_H5Fclose((hid_t)fid) < 0 ? -1 : 0;
}

int f5i_exists(int64_t fid, const char* path) {
    if (!h5lib) return -1;
    // H5Lexists walks one level only; probe each component
    char buf[512];
    size_t n = strlen(path);
    if (n >= sizeof(buf)) return -1;
    memcpy(buf, path, n + 1);
    for (char* c = buf; *c; ++c) {
        if (*c == '/') {
            *c = 0;
            if (buf[0] && p_H5Lexists((hid_t)fid, buf, P_DEFAULT) <= 0)
                return 0;
            *c = '/';
        }
    }
    return p_H5Lexists((hid_t)fid, buf, P_DEFAULT) > 0 ? 1 : 0;
}

int f5i_first_child(int64_t fid, const char* group, char* out, int cap) {
    if (!h5lib) return -1;
    int64_t n = p_H5Lget_name_by_idx((hid_t)fid, group, 0 /*NAME*/,
                                     0 /*INC*/, 0, out, (size_t)cap,
                                     P_DEFAULT);
    return n > 0 ? 0 : -1;
}

// The child link names of a group, each followed by a NUL (a link name
// holds no NUL, but may hold a newline), in one listing call.
// Returns the bytes written, every NUL included; 0 for an empty group,
// -2 when out is too small or a name longer than 255 bytes, -1 when
// unavailable.
long long f5i_list_children(int64_t fid, const char* group, char* out,
                            long long cap) {
    if (!h5lib) return -1;
    long long used = 0;
    for (uint64_t i = 0;; ++i) {
        char name[256];
        int64_t n = p_H5Lget_name_by_idx((hid_t)fid, group, 0 /*NAME*/,
                                         0 /*INC*/, i, name, sizeof(name),
                                         P_DEFAULT);
        if (n <= 0) break;
        if (n >= (int64_t)sizeof(name)) return -2;     // truncated name
        if (used + n + 1 > cap) return -2;
        memcpy(out + used, name, (size_t)n);
        used += n;
        out[used++] = 0;
    }
    return used;
}

// ---- attribute helpers --------------------------------------------------

static int read_attr_f64(hid_t obj, const char* name, double* out) {
    hid_t a = p_H5Aopen(obj, name, P_DEFAULT);
    if (a < 0) return -1;
    herr_t rc = p_H5Aread(a, T_DOUBLE, out);
    p_H5Aclose(a);
    return rc < 0 ? -1 : 0;
}

static int read_attr_i64(hid_t obj, const char* name, long long* out) {
    hid_t a = p_H5Aopen(obj, name, P_DEFAULT);
    if (a < 0) return -1;
    herr_t rc = p_H5Aread(a, T_LLONG, out);
    p_H5Aclose(a);
    return rc < 0 ? -1 : 0;
}

static int read_attr_str(hid_t obj, const char* name, char* out, int cap) {
    hid_t a = p_H5Aopen(obj, name, P_DEFAULT);
    if (a < 0) return -1;
    hid_t ft = p_H5Aget_type(a);
    int rc = -1;
    if (ft >= 0 && p_H5Tget_class(ft) == T_STRING_) {
        if (p_H5Tis_variable_str(ft) > 0) {
            char* ptr = nullptr;
            hid_t mt = p_H5Tcopy(T_C_S1);
            p_H5Tset_size(mt, T_VARIABLE_);
            if (p_H5Aread(a, mt, &ptr) >= 0 && ptr) {
                snprintf(out, (size_t)cap, "%s", ptr);
                p_H5free_memory(ptr);
                rc = 0;
            }
            p_H5Tclose(mt);
        } else {
            size_t sz = p_H5Tget_size(ft);
            if (sz < (size_t)cap) {
                memset(out, 0, (size_t)cap);
                hid_t mt = p_H5Tcopy(T_C_S1);
                p_H5Tset_size(mt, sz + 1);
                if (p_H5Aread(a, mt, out) >= 0) rc = 0;
                p_H5Tclose(mt);
            }
        }
    }
    if (ft >= 0) p_H5Tclose(ft);
    p_H5Aclose(a);
    return rc;
}

// dbl4: digitisation, offset, range, sampling_rate
// i64_2: duration, start_time
// strbuf: 4 x each-cap zero-padded slots: read_id, channel, run_id, sample
int f5i_read_meta(int64_t fid, const char* raw_node,
                  const char* channel_node, const char* tracking_node,
                  double* dbl4, long long* i64_2, char* strbuf, int each) {
    if (!h5lib) return -1;
    hid_t raw = p_H5Oopen((hid_t)fid, raw_node, P_DEFAULT);
    if (raw < 0) return -2;
    int rc = 0;
    rc |= read_attr_i64(raw, "duration", &i64_2[0]);
    rc |= read_attr_i64(raw, "start_time", &i64_2[1]);
    rc |= read_attr_str(raw, "read_id", strbuf, each);
    p_H5Oclose(raw);
    if (rc) return -3;

    hid_t ch = p_H5Oopen((hid_t)fid, channel_node, P_DEFAULT);
    if (ch < 0) return -4;
    rc |= read_attr_str(ch, "channel_number", strbuf + each, each);
    rc |= read_attr_f64(ch, "digitisation", &dbl4[0]);
    rc |= read_attr_f64(ch, "offset", &dbl4[1]);
    rc |= read_attr_f64(ch, "range", &dbl4[2]);
    rc |= read_attr_f64(ch, "sampling_rate", &dbl4[3]);
    p_H5Oclose(ch);
    if (rc) return -5;

    hid_t tr = p_H5Oopen((hid_t)fid, tracking_node, P_DEFAULT);
    if (tr < 0) return -6;
    rc |= read_attr_str(tr, "run_id", strbuf + 2 * each, each);
    rc |= read_attr_str(tr, "sample_id", strbuf + 3 * each, each);
    p_H5Oclose(tr);
    return rc ? -7 : 0;
}

// ---- generic single-attribute reads (basecall summaries) ----------------

int f5i_read_attr_f64(int64_t fid, const char* objpath, const char* name,
                      double* out) {
    if (!h5lib) return -1;
    hid_t o = p_H5Oopen((hid_t)fid, objpath, P_DEFAULT);
    if (o < 0) return -2;
    int rc = read_attr_f64(o, name, out);
    p_H5Oclose(o);
    return rc;
}

int f5i_read_attr_i64(int64_t fid, const char* objpath, const char* name,
                      long long* out) {
    if (!h5lib) return -1;
    hid_t o = p_H5Oopen((hid_t)fid, objpath, P_DEFAULT);
    if (o < 0) return -2;
    int rc = read_attr_i64(o, name, out);
    p_H5Oclose(o);
    return rc;
}

int f5i_attr_exists(int64_t fid, const char* objpath, const char* name) {
    if (!h5lib) return -1;
    hid_t o = p_H5Oopen((hid_t)fid, objpath, P_DEFAULT);
    if (o < 0) return -2;
    int rc = p_H5Aexists(o, name) > 0 ? 1 : 0;
    p_H5Oclose(o);
    return rc;
}

// returns sample count, or <0; fills up to cap samples when out != NULL.
// The stored type must be a <=16-bit integer — HDF5 would otherwise
// CONVERT (clamp) wider/float signals into the i16 buffer silently; such
// containers return -6 so the caller falls back to the h5py reader,
// which routes exotic dtypes through the f32 pA path.
long long f5i_read_signal_i16(int64_t fid, const char* signal_path,
                              int16_t* out, long long cap) {
    if (!h5lib) return -1;
    hid_t d = p_H5Dopen2((hid_t)fid, signal_path, P_DEFAULT);
    if (d < 0) return -2;
    hid_t ft = p_H5Dget_type(d);
    int tclass = ft >= 0 ? p_H5Tget_class(ft) : -1;
    size_t tsize = ft >= 0 ? p_H5Tget_size(ft) : 0;
    if (ft >= 0) p_H5Tclose(ft);
    if (tclass != 0 /*H5T_INTEGER*/ || tsize > 2) {
        p_H5Dclose(d);
        return -6;
    }
    hid_t sp = p_H5Dget_space(d);
    int64_t n = sp >= 0 ? p_H5Sget_simple_extent_npoints(sp) : -1;
    if (sp >= 0) p_H5Sclose(sp);
    if (n < 0) { p_H5Dclose(d); return -3; }
    if (out != nullptr) {
        if (n > cap) { p_H5Dclose(d); return -4; }
        if (p_H5Dread(d, T_INT16, S_ALL, S_ALL, P_DEFAULT, out) < 0) {
            p_H5Dclose(d);
            return -5;
        }
    }
    p_H5Dclose(d);
    return n;
}

// scalar string dataset (Fastq). Returns length written, or <0; -4 when
// the buffer is too small.
long long f5i_read_string_dataset(int64_t fid, const char* path,
                                  char* out, long long cap) {
    if (!h5lib) return -1;
    hid_t d = p_H5Dopen2((hid_t)fid, path, P_DEFAULT);
    if (d < 0) return -2;
    hid_t ft = p_H5Dget_type(d);
    long long rc = -3;
    if (ft >= 0 && p_H5Tget_class(ft) == T_STRING_) {
        if (p_H5Tis_variable_str(ft) > 0) {
            char* ptr = nullptr;
            hid_t mt = p_H5Tcopy(T_C_S1);
            p_H5Tset_size(mt, T_VARIABLE_);
            if (p_H5Dread(d, mt, S_ALL, S_ALL, P_DEFAULT, &ptr) >= 0 && ptr) {
                long long n = (long long)strlen(ptr);
                if (n < cap) { memcpy(out, ptr, (size_t)n + 1); rc = n; }
                else rc = -4;
                p_H5free_memory(ptr);
            }
            p_H5Tclose(mt);
        } else {
            long long sz = (long long)p_H5Tget_size(ft);
            if (sz + 1 < cap) {
                memset(out, 0, (size_t)sz + 1);
                hid_t mt = p_H5Tcopy(T_C_S1);
                p_H5Tset_size(mt, (size_t)sz + 1);
                if (p_H5Dread(d, mt, S_ALL, S_ALL, P_DEFAULT, out) >= 0)
                    rc = (long long)strlen(out);
                p_H5Tclose(mt);
            } else rc = -4;
        }
    }
    if (ft >= 0) p_H5Tclose(ft);
    p_H5Dclose(d);
    return rc;
}

// ---- albacore events: compound member-selected read ---------------------
// Memory row layout (natural 8-byte alignment; mirrored by a numpy dtype
// on the Python side):
struct EventRow {
    double mean;
    double p_model_state;
    unsigned long long start;
    long long move;
    char model_state[8];
};

// Reads the named columns of an albacore >= 2.3 Events table. Returns the
// number of events, or <0 (-1 unavailable, -4 too many rows for the
// buffer, -6 not a 14-column albacore table). n_members_out gets the
// compound's member count (14 for albacore); state_size_out the stored
// model_state string size.
long long f5i_read_events(int64_t fid, const char* events_path,
                          struct EventRow* out, long long cap_rows,
                          long long* n_members_out,
                          long long* state_size_out) {
    if (!h5lib) return -1;
    hid_t d = p_H5Dopen2((hid_t)fid, events_path, P_DEFAULT);
    if (d < 0) return -2;
    long long rc = -3;
    hid_t ft = p_H5Dget_type(d);
    hid_t sp = p_H5Dget_space(d);
    if (ft >= 0 && sp >= 0 && p_H5Tget_class(ft) == T_COMPOUND_) {
        long long n = p_H5Sget_simple_extent_npoints(sp);
        // strict requirement: every consumed member exists (a guppy
        // Move/3-column table fails this and falls back to Python)
        int im = p_H5Tget_member_index(ft, "mean");
        int is = p_H5Tget_member_index(ft, "start");
        int iv = p_H5Tget_member_index(ft, "move");
        int ip = p_H5Tget_member_index(ft, "p_model_state");
        int ist = p_H5Tget_member_index(ft, "model_state");
        int nmem = p_H5Tget_nmembers(ft);
        if (n_members_out) *n_members_out = (long long)nmem;
        if (im >= 0 && is >= 0 && iv >= 0 && ip >= 0 && ist >= 0) {
            if (n > cap_rows) { rc = -4; }
            else {
                size_t ssize = 5;
                hid_t stype = p_H5Tget_member_type(ft, (unsigned)ist);
                if (stype >= 0) {
                    size_t s = p_H5Tget_size(stype);
                    if (s > 0 && s < 8) ssize = s;
                    p_H5Tclose(stype);
                }
                if (state_size_out) *state_size_out = (long long)ssize;
                hid_t strt = p_H5Tcopy(T_C_S1);
                p_H5Tset_size(strt, 8);
                hid_t mt = p_H5Tcreate(T_COMPOUND_, sizeof(struct EventRow));
                p_H5Tinsert(mt, "mean",
                            offsetof(struct EventRow, mean), T_DOUBLE);
                p_H5Tinsert(mt, "p_model_state",
                            offsetof(struct EventRow, p_model_state),
                            T_DOUBLE);
                p_H5Tinsert(mt, "start",
                            offsetof(struct EventRow, start), T_ULLONG);
                p_H5Tinsert(mt, "move",
                            offsetof(struct EventRow, move), T_LLONG);
                p_H5Tinsert(mt, "model_state",
                            offsetof(struct EventRow, model_state), strt);
                if (p_H5Dread(d, mt, S_ALL, S_ALL, P_DEFAULT, out) >= 0)
                    rc = n;
                else
                    rc = -5;
                p_H5Tclose(mt);
                p_H5Tclose(strt);
            }
        } else {
            rc = -6;
        }
    }
    if (sp >= 0) p_H5Sclose(sp);
    if (ft >= 0) p_H5Tclose(ft);
    p_H5Dclose(d);
    return rc;
}

}  // extern "C"
