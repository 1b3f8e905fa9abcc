// Native execution core for the wasm interpreter (wasm/interp.py).
//
// The Python interpreter stays the semantic reference and fallback; this
// file ports ONLY the hot dispatch loop. The module is decoded and
// validated in Python (wasm/binary.py), then translated into flat
// op/immediate arrays (wasm/native_exec.py) and executed here. Host
// imports (the waPC/OPA/WASI ABIs) call back into Python through a
// single dispatcher callback; linear memory lives here and Python reads
// and writes it through accessor functions.
//
// Semantics mirror interp.py operation for operation — including its
// Python-derived float min/max ordering, round-half-even "nearest", and
// trap messages — so the two engines stay drop-in interchangeable and
// differential-testable.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <ctime>
#include <exception>
#include <new>
#include <vector>

namespace {

union Val {
    int64_t i;
    double f;
};

// status codes (mirrored in wasm/native_exec.py)
enum {
    OK = 0,
    TRAP = 1,
    FUEL = 2,
    DEADLINE = 3,
    HOSTERR = 4,
};

typedef int32_t (*HostCb)(void* ctx, int32_t fidx, const uint64_t* args,
                          int32_t nargs, uint64_t* results,
                          int32_t* nresults);

struct Func {
    int32_t type_id = 0;
    int32_t n_params = 0;
    int32_t n_results = 0;
    int32_t n_locals = 0;  // extra zero-initialised locals
    uint8_t is_host = 0;
    std::vector<uint32_t> ops;
    std::vector<int64_t> ia;
    std::vector<int32_t> ib;
    std::vector<int32_t> ic;
};

struct DataSeg {
    std::vector<uint8_t> bytes;
};

struct Module {
    std::vector<Func> funcs;
    std::vector<int32_t> br_pool;
    std::vector<DataSeg> data;
};

struct Ctrl {
    int32_t target_pc;
    int32_t height;
    int32_t arity;
    uint8_t is_loop;
};

struct Inst {
    Module* mod = nullptr;
    std::vector<uint8_t> mem;
    int64_t mem_max_pages = -1;  // -1: no declared maximum
    std::vector<Val> globals;
    std::vector<std::vector<int32_t>> tables;  // -1 = null element
    std::vector<uint8_t> data_dropped;
    int64_t fuel = 0;
    uint8_t has_fuel = 0;
    double deadline = 0.0;
    uint8_t has_deadline = 0;
    HostCb hostcb = nullptr;
    void* host_ctx = nullptr;
    int32_t depth = 0;
    int32_t err_code = OK;
    char err[512] = {0};
};

constexpr int64_t PAGE = 65536;
constexpr int32_t MAX_DEPTH = 1024;

int32_t trap(Inst* in, int32_t code, const char* msg) {
    in->err_code = code;
    snprintf(in->err, sizeof(in->err), "%s", msg);
    return code;
}

double mono_now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

inline int32_t I32(int64_t v) { return (int32_t)v; }
inline uint32_t U32(int64_t v) { return (uint32_t)v; }
inline uint64_t U64(int64_t v) { return (uint64_t)v; }
inline double F32(double v) { return (double)(float)v; }

// CPython min/max ordering (interp.py uses builtin min/max on floats):
// min(a, b) keeps a unless b < a; max keeps a unless b > a. NaN
// comparisons are false, so a NaN FIRST operand wins. Replicated so the
// engines agree bit-for-bit on NaN-bearing policies.
inline double pymin(double a, double b) { return (b < a) ? b : a; }
inline double pymax(double a, double b) { return (b > a) ? b : a; }

bool mem_ok(Inst* in, uint64_t addr, uint64_t n) {
    return addr + n <= in->mem.size() && addr + n >= addr;
}

int32_t exec_fn(Inst* in, const Func& fn, const Val* args, Val* results,
                int32_t* nresults);

int32_t call_index(Inst* in, int32_t findex, const Val* args, Val* results,
                   int32_t* nresults) {
    const Func& callee = in->mod->funcs[findex];
    if (callee.is_host) {
        uint64_t raw_args[32];
        uint64_t raw_res[32];
        int32_t nres = 0;
        for (int32_t i = 0; i < callee.n_params && i < 32; i++)
            memcpy(&raw_args[i], &args[i], 8);
        int32_t rc = in->hostcb(in->host_ctx, findex, raw_args,
                                callee.n_params, raw_res, &nres);
        if (rc != 0)
            return trap(in, HOSTERR, "host function raised");
        for (int32_t i = 0; i < nres && i < 32; i++)
            memcpy(&results[i], &raw_res[i], 8);
        *nresults = nres;
        return OK;
    }
    return exec_fn(in, callee, args, results, nresults);
}

// br mechanics, mirroring interp.py::_branch. Returns new pc in *npc, or
// sets *returned when the branch targets the function body.
void do_branch(int32_t label, std::vector<Ctrl>& ctrl, std::vector<Val>& stack,
               int32_t* npc, bool* returned) {
    if (label >= (int32_t)ctrl.size()) {
        *returned = true;
        return;
    }
    for (int32_t k = 0; k < label; k++) ctrl.pop_back();
    Ctrl c = ctrl.back();  // by value: the non-loop case pops it below
    int32_t arity = c.arity;
    // move `arity` results down to c.height
    for (int32_t k = 0; k < arity; k++)
        stack[c.height + k] = stack[stack.size() - arity + k];
    stack.resize(c.height + arity);
    if (c.is_loop) {
        *npc = c.target_pc + 1;  // continue after the loop header
    } else {
        ctrl.pop_back();
        *npc = c.target_pc + 1;  // continue after the matching END
    }
    *returned = false;
}

int32_t exec_fn(Inst* in, const Func& fn, const Val* args, Val* results,
                int32_t* nresults) {
    if (++in->depth > MAX_DEPTH) {
        in->depth--;
        return trap(in, TRAP, "call stack exhausted");
    }
    std::vector<Val> locals(fn.n_params + fn.n_locals);
    for (int32_t i = 0; i < fn.n_params; i++) locals[i] = args[i];
    for (int32_t i = fn.n_params; i < (int32_t)locals.size(); i++)
        locals[i].i = 0;
    std::vector<Val> stack;
    stack.reserve(64);
    std::vector<Ctrl> ctrl;
    ctrl.reserve(16);

    const uint32_t* ops = fn.ops.data();
    const int64_t* ia = fn.ia.data();
    const int32_t* ib = fn.ib.data();
    const int32_t* ic = fn.ic.data();
    int32_t pc = 0;

#define RET_RESULTS()                                                     \
    do {                                                                  \
        int32_t n = fn.n_results;                                         \
        for (int32_t k = 0; k < n; k++)                                   \
            results[k] = stack[stack.size() - n + k];                     \
        *nresults = n;                                                    \
        in->depth--;                                                      \
        return OK;                                                        \
    } while (0)
#define TRAPF(msg)                                                        \
    do {                                                                  \
        in->depth--;                                                      \
        return trap(in, TRAP, msg);                                       \
    } while (0)
#define POP() (stack.back().i);  // (unused helper removed)

    for (;;) {
        if (in->has_fuel) {
            in->fuel--;
            if (in->fuel <= 0) {
                in->fuel = 0;
                in->depth--;
                return trap(in, FUEL, "wasm fuel exhausted");
            }
            if (in->has_deadline && (in->fuel & 0xFFFF) == 0 &&
                mono_now() >= in->deadline) {
                in->depth--;
                return trap(in, DEADLINE, "wasm wall-clock deadline exceeded");
            }
        }
        uint32_t op = ops[pc];
        switch (op) {
            case 0x20:  // local.get
                stack.push_back(locals[ia[pc]]);
                break;
            case 0x21:  // local.set
                locals[ia[pc]] = stack.back();
                stack.pop_back();
                break;
            case 0x22:  // local.tee
                locals[ia[pc]] = stack.back();
                break;
            case 0x41:
            case 0x42: {  // i32/i64.const
                Val v;
                v.i = ia[pc];
                stack.push_back(v);
                break;
            }
            case 0x43:
            case 0x44: {  // f32/f64.const (double bits in ia)
                Val v;
                memcpy(&v.f, &ia[pc], 8);
                stack.push_back(v);
                break;
            }
            case 0x02: {  // block
                int32_t params = ib[pc];
                int32_t res = ic[pc];
                ctrl.push_back({(int32_t)ia[pc],
                                (int32_t)stack.size() - params, res, 0});
                break;
            }
            case 0x03: {  // loop
                int32_t params = ib[pc];
                ctrl.push_back({pc, (int32_t)stack.size() - params, params, 1});
                break;
            }
            case 0x04: {  // if: ia=end, ib=else(-1), ic=(params<<16)|results
                int32_t params = ic[pc] >> 16;
                int32_t res = ic[pc] & 0xFFFF;
                int64_t cond = stack.back().i;
                stack.pop_back();
                if (cond) {
                    ctrl.push_back({(int32_t)ia[pc],
                                    (int32_t)stack.size() - params, res, 0});
                } else if (ib[pc] >= 0) {
                    ctrl.push_back({(int32_t)ia[pc],
                                    (int32_t)stack.size() - params, res, 0});
                    pc = ib[pc];
                } else {
                    pc = (int32_t)ia[pc];  // past END; no frame pushed
                }
                break;
            }
            case 0x05:  // else (reached from then-branch): jump to end
                pc = (int32_t)ia[pc];
                ctrl.pop_back();
                break;
            case 0x0B:  // end
                if (!ctrl.empty()) {
                    ctrl.pop_back();
                } else {
                    RET_RESULTS();
                }
                break;
            case 0x0C: {  // br
                bool returned;
                int32_t npc;
                do_branch((int32_t)ia[pc], ctrl, stack, &npc, &returned);
                if (returned) RET_RESULTS();
                pc = npc;
                continue;
            }
            case 0x0D: {  // br_if
                int64_t cond = stack.back().i;
                stack.pop_back();
                if (cond) {
                    bool returned;
                    int32_t npc;
                    do_branch((int32_t)ia[pc], ctrl, stack, &npc, &returned);
                    if (returned) RET_RESULTS();
                    pc = npc;
                    continue;
                }
                break;
            }
            case 0x0E: {  // br_table: ia=pool start, ib=count
                uint32_t i = U32(stack.back().i);
                stack.pop_back();
                int32_t start = (int32_t)ia[pc];
                int32_t count = ib[pc];
                int32_t label = (i < (uint32_t)count)
                                    ? in->mod->br_pool[start + i]
                                    : in->mod->br_pool[start + count];
                bool returned;
                int32_t npc;
                do_branch(label, ctrl, stack, &npc, &returned);
                if (returned) RET_RESULTS();
                pc = npc;
                continue;
            }
            case 0x0F:  // return
                RET_RESULTS();
            case 0x10: {  // call
                int32_t findex = (int32_t)ia[pc];
                const Func& callee = in->mod->funcs[findex];
                int32_t n = callee.n_params;
                Val sub_args[32];
                for (int32_t k = 0; k < n; k++)
                    sub_args[k] = stack[stack.size() - n + k];
                stack.resize(stack.size() - n);
                Val sub_res[32];
                int32_t nres = 0;
                int32_t rc = call_index(in, findex, sub_args, sub_res, &nres);
                if (rc != OK) {
                    in->depth--;
                    return rc;
                }
                for (int32_t k = 0; k < nres; k++) stack.push_back(sub_res[k]);
                break;
            }
            case 0x11: {  // call_indirect: ia=type id, ib=table idx
                uint32_t elem = U32(stack.back().i);
                stack.pop_back();
                std::vector<int32_t>& table = in->tables[ib[pc]];
                if (elem >= table.size() || table[elem] < 0)
                    TRAPF("undefined element");
                int32_t findex = table[elem];
                const Func& callee = in->mod->funcs[findex];
                if (callee.type_id != (int32_t)ia[pc])
                    TRAPF("indirect call type mismatch");
                int32_t n = callee.n_params;
                Val sub_args[32];
                for (int32_t k = 0; k < n; k++)
                    sub_args[k] = stack[stack.size() - n + k];
                stack.resize(stack.size() - n);
                Val sub_res[32];
                int32_t nres = 0;
                int32_t rc = call_index(in, findex, sub_args, sub_res, &nres);
                if (rc != OK) {
                    in->depth--;
                    return rc;
                }
                for (int32_t k = 0; k < nres; k++) stack.push_back(sub_res[k]);
                break;
            }
            case 0x00:
                TRAPF("unreachable");
            case 0x01:  // nop
                break;
            case 0x1A:  // drop
                stack.pop_back();
                break;
            case 0x1B: {  // select
                Val c = stack.back();
                stack.pop_back();
                Val bv = stack.back();
                stack.pop_back();
                if (!c.i) stack.back() = bv;
                break;
            }
            case 0x23:  // global.get
                stack.push_back(in->globals[ia[pc]]);
                break;
            case 0x24:  // global.set
                in->globals[ia[pc]] = stack.back();
                stack.pop_back();
                break;

#define LOAD(nbytes, signedload, push64)                                      \
    {                                                                         \
        uint64_t addr = (uint64_t)U32(stack.back().i) + (uint64_t)ia[pc];     \
        stack.pop_back();                                                     \
        if (!mem_ok(in, addr, nbytes)) TRAPF("out of bounds memory access");  \
        uint64_t raw = 0;                                                     \
        memcpy(&raw, in->mem.data() + addr, nbytes);                          \
        int64_t out;                                                          \
        if (signedload) {                                                     \
            int shift = 64 - (nbytes)*8;                                      \
            out = ((int64_t)(raw << shift)) >> shift;                         \
        } else {                                                              \
            out = (int64_t)raw;                                               \
        }                                                                     \
        if (!(push64) && (signedload)) out = (int64_t)(int32_t)out;           \
        Val v;                                                                \
        v.i = out;                                                            \
        stack.push_back(v);                                                   \
    }

            case 0x28:  // i32.load (sign-extended into the slot, like _i32)
                LOAD(4, true, false);
                break;
            case 0x29:  // i64.load
                LOAD(8, true, true);
                break;
            case 0x2A: {  // f32.load
                uint64_t addr = (uint64_t)U32(stack.back().i) + (uint64_t)ia[pc];
                stack.pop_back();
                if (!mem_ok(in, addr, 4)) TRAPF("out of bounds memory access");
                float f;
                memcpy(&f, in->mem.data() + addr, 4);
                Val v;
                v.f = (double)f;
                stack.push_back(v);
                break;
            }
            case 0x2B: {  // f64.load
                uint64_t addr = (uint64_t)U32(stack.back().i) + (uint64_t)ia[pc];
                stack.pop_back();
                if (!mem_ok(in, addr, 8)) TRAPF("out of bounds memory access");
                Val v;
                memcpy(&v.f, in->mem.data() + addr, 8);
                stack.push_back(v);
                break;
            }
            case 0x2C:  // i32.load8_s
            case 0x30:  // i64.load8_s
                LOAD(1, true, true);
                break;
            case 0x2D:  // i32.load8_u
            case 0x31:  // i64.load8_u
                LOAD(1, false, true);
                break;
            case 0x2E:  // i32.load16_s
            case 0x32:  // i64.load16_s
                LOAD(2, true, true);
                break;
            case 0x2F:  // i32.load16_u
            case 0x33:  // i64.load16_u
                LOAD(2, false, true);
                break;
            case 0x34:  // i64.load32_s
                LOAD(4, true, true);
                break;
            case 0x35:  // i64.load32_u
                LOAD(4, false, true);
                break;

#define STORE(nbytes, maskexpr)                                               \
    {                                                                         \
        int64_t v = stack.back().i;                                           \
        stack.pop_back();                                                     \
        uint64_t addr = (uint64_t)U32(stack.back().i) + (uint64_t)ia[pc];     \
        stack.pop_back();                                                     \
        if (!mem_ok(in, addr, nbytes)) TRAPF("out of bounds memory access");  \
        uint64_t raw = (maskexpr);                                            \
        memcpy(in->mem.data() + addr, &raw, nbytes);                          \
    }

            case 0x36:  // i32.store
                STORE(4, (uint64_t)U32(v));
                break;
            case 0x37:  // i64.store
                STORE(8, U64(v));
                break;
            case 0x38: {  // f32.store
                double d = stack.back().f;
                stack.pop_back();
                uint64_t addr = (uint64_t)U32(stack.back().i) + (uint64_t)ia[pc];
                stack.pop_back();
                if (!mem_ok(in, addr, 4)) TRAPF("out of bounds memory access");
                float f = (float)d;
                memcpy(in->mem.data() + addr, &f, 4);
                break;
            }
            case 0x39: {  // f64.store
                double d = stack.back().f;
                stack.pop_back();
                uint64_t addr = (uint64_t)U32(stack.back().i) + (uint64_t)ia[pc];
                stack.pop_back();
                if (!mem_ok(in, addr, 8)) TRAPF("out of bounds memory access");
                memcpy(in->mem.data() + addr, &d, 8);
                break;
            }
            case 0x3A:  // i32.store8
            case 0x3C:  // i64.store8
                STORE(1, U64(v) & 0xFF);
                break;
            case 0x3B:  // i32.store16
            case 0x3D:  // i64.store16
                STORE(2, U64(v) & 0xFFFF);
                break;
            case 0x3E:  // i64.store32
                STORE(4, U64(v) & 0xFFFFFFFFull);
                break;
            case 0x3F: {  // memory.size
                Val v;
                v.i = (int64_t)(in->mem.size() / PAGE);
                stack.push_back(v);
                break;
            }
            case 0x40: {  // memory.grow
                int64_t delta = (int64_t)U32(stack.back().i);
                stack.pop_back();
                int64_t old_pages = (int64_t)(in->mem.size() / PAGE);
                int64_t new_pages = old_pages + delta;
                Val v;
                if ((in->mem_max_pages >= 0 && new_pages > in->mem_max_pages) ||
                    new_pages > 65536) {
                    v.i = -1;
                } else {
                    in->mem.resize((size_t)(new_pages * PAGE), 0);
                    v.i = old_pages;
                }
                stack.push_back(v);
                break;
            }

#define BINI(...)                                                             \
    {                                                                         \
        int64_t b = stack.back().i;                                           \
        stack.pop_back();                                                     \
        int64_t a = stack.back().i;                                           \
        int64_t r;                                                            \
        __VA_ARGS__;                                                          \
        stack.back().i = r;                                                   \
    }
#define CMP(...)                                                              \
    BINI({ r = (__VA_ARGS__) ? 1 : 0; })

            // i32 compare
            case 0x45: {  // i32.eqz
                stack.back().i = (stack.back().i == 0) ? 1 : 0;
                break;
            }
            case 0x46: CMP(U32(a) == U32(b)); break;
            case 0x47: CMP(U32(a) != U32(b)); break;
            case 0x48: CMP(I32(a) < I32(b)); break;
            case 0x49: CMP(U32(a) < U32(b)); break;
            case 0x4A: CMP(I32(a) > I32(b)); break;
            case 0x4B: CMP(U32(a) > U32(b)); break;
            case 0x4C: CMP(I32(a) <= I32(b)); break;
            case 0x4D: CMP(U32(a) <= U32(b)); break;
            case 0x4E: CMP(I32(a) >= I32(b)); break;
            case 0x4F: CMP(U32(a) >= U32(b)); break;
            // i64 compare
            case 0x50:
                stack.back().i = (stack.back().i == 0) ? 1 : 0;
                break;
            case 0x51: CMP(U64(a) == U64(b)); break;
            case 0x52: CMP(U64(a) != U64(b)); break;
            case 0x53: CMP(a < b); break;
            case 0x54: CMP(U64(a) < U64(b)); break;
            case 0x55: CMP(a > b); break;
            case 0x56: CMP(U64(a) > U64(b)); break;
            case 0x57: CMP(a <= b); break;
            case 0x58: CMP(U64(a) <= U64(b)); break;
            case 0x59: CMP(a >= b); break;
            case 0x5A: CMP(U64(a) >= U64(b)); break;

#define FCMP(expr)                                                            \
    {                                                                         \
        double b = stack.back().f;                                            \
        stack.pop_back();                                                     \
        double a = stack.back().f;                                            \
        stack.back().i = (expr) ? 1 : 0;                                      \
    }
            case 0x5B: case 0x61: FCMP(a == b); break;
            case 0x5C: case 0x62: FCMP(a != b); break;
            case 0x5D: case 0x63: FCMP(a < b); break;
            case 0x5E: case 0x64: FCMP(a > b); break;
            case 0x5F: case 0x65: FCMP(a <= b); break;
            case 0x60: case 0x66: FCMP(a >= b); break;

            // i32 arithmetic
            case 0x67: {  // i32.clz
                uint32_t v = U32(stack.back().i);
                stack.back().i = v == 0 ? 32 : __builtin_clz(v);
                break;
            }
            case 0x68: {  // i32.ctz
                uint32_t v = U32(stack.back().i);
                stack.back().i = v == 0 ? 32 : __builtin_ctz(v);
                break;
            }
            case 0x69:
                stack.back().i = __builtin_popcount(U32(stack.back().i));
                break;
            case 0x6A: BINI({ r = (int64_t)(int32_t)(U32(a) + U32(b)); }); break;
            case 0x6B: BINI({ r = (int64_t)(int32_t)(U32(a) - U32(b)); }); break;
            case 0x6C: BINI({ r = (int64_t)(int32_t)(U32(a) * U32(b)); }); break;
            case 0x6D:
                BINI({
                    int32_t x = I32(a), y = I32(b);
                    if (y == 0) TRAPF("integer divide by zero");
                    if (x == INT32_MIN && y == -1) TRAPF("integer overflow");
                    r = (int64_t)(x / y);
                });
                break;
            case 0x6E:
                BINI({
                    uint32_t x = U32(a), y = U32(b);
                    if (y == 0) TRAPF("integer divide by zero");
                    r = (int64_t)(int32_t)(x / y);
                });
                break;
            case 0x6F:
                BINI({
                    int32_t x = I32(a), y = I32(b);
                    if (y == 0) TRAPF("integer divide by zero");
                    r = (y == -1) ? 0 : (int64_t)(x % y);
                });
                break;
            case 0x70:
                BINI({
                    uint32_t x = U32(a), y = U32(b);
                    if (y == 0) TRAPF("integer divide by zero");
                    r = (int64_t)(int32_t)(x % y);
                });
                break;
            case 0x71: BINI({ r = (int64_t)(int32_t)(U32(a) & U32(b)); }); break;
            case 0x72: BINI({ r = (int64_t)(int32_t)(U32(a) | U32(b)); }); break;
            case 0x73: BINI({ r = (int64_t)(int32_t)(U32(a) ^ U32(b)); }); break;
            case 0x74:
                BINI({ r = (int64_t)(int32_t)(U32(a) << (b & 31)); });
                break;
            case 0x75: BINI({ r = (int64_t)(I32(a) >> (b & 31)); }); break;
            case 0x76:
                BINI({ r = (int64_t)(int32_t)(U32(a) >> (b & 31)); });
                break;
            case 0x77:
                BINI({
                    uint32_t s = (uint32_t)(b & 31), x = U32(a);
                    r = (int64_t)(int32_t)(s ? ((x << s) | (x >> (32 - s))) : x);
                });
                break;
            case 0x78:
                BINI({
                    uint32_t s = (uint32_t)(b & 31), x = U32(a);
                    r = (int64_t)(int32_t)(s ? ((x >> s) | (x << (32 - s))) : x);
                });
                break;
            // i64 arithmetic
            case 0x79: {
                uint64_t v = U64(stack.back().i);
                stack.back().i = v == 0 ? 64 : __builtin_clzll(v);
                break;
            }
            case 0x7A: {
                uint64_t v = U64(stack.back().i);
                stack.back().i = v == 0 ? 64 : __builtin_ctzll(v);
                break;
            }
            case 0x7B:
                stack.back().i = __builtin_popcountll(U64(stack.back().i));
                break;
            case 0x7C: BINI({ r = (int64_t)(U64(a) + U64(b)); }); break;
            case 0x7D: BINI({ r = (int64_t)(U64(a) - U64(b)); }); break;
            case 0x7E: BINI({ r = (int64_t)(U64(a) * U64(b)); }); break;
            case 0x7F:
                BINI({
                    if (b == 0) TRAPF("integer divide by zero");
                    if (a == INT64_MIN && b == -1) TRAPF("integer overflow");
                    r = a / b;
                });
                break;
            case 0x80:
                BINI({
                    if (b == 0) TRAPF("integer divide by zero");
                    r = (int64_t)(U64(a) / U64(b));
                });
                break;
            case 0x81:
                BINI({
                    if (b == 0) TRAPF("integer divide by zero");
                    r = (b == -1) ? 0 : a % b;
                });
                break;
            case 0x82:
                BINI({
                    if (b == 0) TRAPF("integer divide by zero");
                    r = (int64_t)(U64(a) % U64(b));
                });
                break;
            case 0x83: BINI({ r = a & b; }); break;
            case 0x84: BINI({ r = a | b; }); break;
            case 0x85: BINI({ r = a ^ b; }); break;
            case 0x86: BINI({ r = (int64_t)(U64(a) << (b & 63)); }); break;
            case 0x87: BINI({ r = a >> (b & 63); }); break;
            case 0x88: BINI({ r = (int64_t)(U64(a) >> (b & 63)); }); break;
            case 0x89:
                BINI({
                    uint64_t s = (uint64_t)(b & 63), x = U64(a);
                    r = (int64_t)(s ? ((x << s) | (x >> (64 - s))) : x);
                });
                break;
            case 0x8A:
                BINI({
                    uint64_t s = (uint64_t)(b & 63), x = U64(a);
                    r = (int64_t)(s ? ((x >> s) | (x << (64 - s))) : x);
                });
                break;

            // float unary/binary (f32 ops round results through float)
            case 0x8B: case 0x99: stack.back().f = fabs(stack.back().f); break;
            case 0x8C: case 0x9A: stack.back().f = -stack.back().f; break;
            case 0x8D: stack.back().f = F32(ceil(stack.back().f)); break;
            case 0x9B: stack.back().f = ceil(stack.back().f); break;
            case 0x8E: stack.back().f = F32(floor(stack.back().f)); break;
            case 0x9C: stack.back().f = floor(stack.back().f); break;
            case 0x8F: stack.back().f = F32(trunc(stack.back().f)); break;
            case 0x9D: stack.back().f = trunc(stack.back().f); break;
            case 0x90:
            case 0x9E: {  // nearest (round half to even, via interp.py's math)
                double v = stack.back().f;
                double fl = floor(v);
                double d = v - fl;
                double n;
                if (d > 0.5) n = fl + 1;
                else if (d < 0.5) n = fl;
                else n = (fmod(fl, 2.0) == 0.0) ? fl : fl + 1;
                stack.back().f = (op == 0x90) ? F32(n) : n;
                break;
            }
            case 0x91: stack.back().f = F32(sqrt(stack.back().f)); break;
            case 0x9F: stack.back().f = sqrt(stack.back().f); break;

#define FBIN(expr, round32)                                                   \
    {                                                                         \
        double b = stack.back().f;                                            \
        stack.pop_back();                                                     \
        double a = stack.back().f;                                            \
        double r = (expr);                                                    \
        stack.back().f = (round32) ? F32(r) : r;                              \
        (void)a;                                                              \
        (void)b;                                                              \
    }
            case 0x92: FBIN(a + b, true); break;
            case 0x93: FBIN(a - b, true); break;
            case 0x94: FBIN(a * b, true); break;
            case 0x95: FBIN(a / b, true); break;
            case 0x96: FBIN(pymin(a, b), false); break;
            case 0x97: FBIN(pymax(a, b), false); break;
            case 0x98: FBIN(copysign(a, b), false); break;
            case 0xA0: FBIN(a + b, false); break;
            case 0xA1: FBIN(a - b, false); break;
            case 0xA2: FBIN(a * b, false); break;
            case 0xA3: FBIN(a / b, false); break;
            case 0xA4: FBIN(pymin(a, b), false); break;
            case 0xA5: FBIN(pymax(a, b), false); break;
            case 0xA6: FBIN(copysign(a, b), false); break;

            // conversions
            case 0xA7:  // i32.wrap_i64
                stack.back().i = (int64_t)(int32_t)stack.back().i;
                break;
            case 0xA8:
            case 0xAA: {  // i32.trunc_f*_s
                double v = stack.back().f;
                if (std::isnan(v) || std::isinf(v))
                    TRAPF("invalid conversion to integer");
                double t = trunc(v);
                if (t < -2147483648.0 || t > 2147483647.0)
                    TRAPF("integer overflow");
                stack.back().i = (int64_t)t;
                break;
            }
            case 0xA9:
            case 0xAB: {  // i32.trunc_f*_u
                double v = stack.back().f;
                if (std::isnan(v) || std::isinf(v))
                    TRAPF("invalid conversion to integer");
                double t = trunc(v);
                if (t < 0.0 || t > 4294967295.0) TRAPF("integer overflow");
                stack.back().i = (int64_t)(int32_t)(uint32_t)(uint64_t)t;
                break;
            }
            case 0xAC:  // i64.extend_i32_s
                stack.back().i = (int64_t)(int32_t)stack.back().i;
                break;
            case 0xAD:  // i64.extend_i32_u
                stack.back().i = (int64_t)(uint32_t)stack.back().i;
                break;
            case 0xAE:
            case 0xB0: {  // i64.trunc_f*_s
                double v = stack.back().f;
                if (std::isnan(v) || std::isinf(v))
                    TRAPF("invalid conversion to integer");
                double t = trunc(v);
                if (t < -9223372036854775808.0 || t >= 9223372036854775808.0)
                    TRAPF("integer overflow");
                stack.back().i = (int64_t)t;
                break;
            }
            case 0xAF:
            case 0xB1: {  // i64.trunc_f*_u
                double v = stack.back().f;
                if (std::isnan(v) || std::isinf(v))
                    TRAPF("invalid conversion to integer");
                double t = trunc(v);
                if (t < 0.0 || t >= 18446744073709551616.0)
                    TRAPF("integer overflow");
                stack.back().i = (int64_t)(uint64_t)t;
                break;
            }
            case 0xB2:
                stack.back().f = F32((double)stack.back().i);
                break;
            case 0xB3:
                stack.back().f = F32((double)(uint32_t)stack.back().i);
                break;
            case 0xB4:
                stack.back().f = F32((double)stack.back().i);
                break;
            case 0xB5:
                stack.back().f = F32((double)U64(stack.back().i));
                break;
            case 0xB6:  // f32.demote_f64
                stack.back().f = F32(stack.back().f);
                break;
            case 0xB7:
                stack.back().f = (double)stack.back().i;
                break;
            case 0xB8:
                stack.back().f = (double)(uint32_t)stack.back().i;
                break;
            case 0xB9:
                stack.back().f = (double)stack.back().i;
                break;
            case 0xBA:
                stack.back().f = (double)U64(stack.back().i);
                break;
            case 0xBB:  // f64.promote_f32 (slot already double)
                break;
            case 0xBC: {  // i32.reinterpret_f32
                float f = (float)stack.back().f;
                int32_t bits;
                memcpy(&bits, &f, 4);
                stack.back().i = (int64_t)bits;
                break;
            }
            case 0xBD: {  // i64.reinterpret_f64
                int64_t bits;
                memcpy(&bits, &stack.back().f, 8);
                stack.back().i = bits;
                break;
            }
            case 0xBE: {  // f32.reinterpret_i32
                uint32_t bits = U32(stack.back().i);
                float f;
                memcpy(&f, &bits, 4);
                stack.back().f = (double)f;
                break;
            }
            case 0xBF: {  // f64.reinterpret_i64
                uint64_t bits = U64(stack.back().i);
                memcpy(&stack.back().f, &bits, 8);
                break;
            }
            // sign extension
            case 0xC0:
            case 0xC2: {
                int64_t v = stack.back().i & 0xFF;
                stack.back().i = (v & 0x80) ? v - 256 : v;
                break;
            }
            case 0xC1:
            case 0xC3: {
                int64_t v = stack.back().i & 0xFFFF;
                stack.back().i = (v & 0x8000) ? v - 65536 : v;
                break;
            }
            case 0xC4:  // i64.extend32_s
                stack.back().i = (int64_t)(int32_t)stack.back().i;
                break;

            default:
                if (op >= 0xFC00) {
                    uint32_t sub = op & 0xFF;
                    if (sub <= 7) {  // saturating trunc
                        double v = stack.back().f;
                        bool issigned = (sub % 2) == 0;
                        bool to64 = sub >= 4;
                        int64_t out;
                        if (std::isnan(v)) {
                            out = 0;
                        } else {
                            double t = std::isinf(v) ? v : trunc(v);
                            if (to64) {
                                if (issigned) {
                                    if (t <= -9223372036854775808.0)
                                        out = INT64_MIN;
                                    else if (t >= 9223372036854775807.0)
                                        out = INT64_MAX;
                                    else
                                        out = (int64_t)t;
                                } else {
                                    if (t <= 0.0)
                                        out = 0;
                                    else if (t >= 18446744073709551615.0)
                                        out = (int64_t)UINT64_MAX;
                                    else
                                        out = (int64_t)(uint64_t)t;
                                }
                            } else {
                                if (issigned) {
                                    if (t <= -2147483648.0)
                                        out = INT32_MIN;
                                    else if (t >= 2147483647.0)
                                        out = INT32_MAX;
                                    else
                                        out = (int64_t)(int32_t)t;
                                } else {
                                    if (t <= 0.0)
                                        out = 0;
                                    else if (t >= 4294967295.0)
                                        out = (int64_t)(int32_t)UINT32_MAX;
                                    else
                                        out = (int64_t)(int32_t)(uint32_t)t;
                                }
                            }
                        }
                        stack.back().i = out;
                    } else if (sub == 8) {  // memory.init
                        uint32_t n = U32(stack.back().i);
                        stack.pop_back();
                        uint32_t src = U32(stack.back().i);
                        stack.pop_back();
                        uint32_t dst = U32(stack.back().i);
                        stack.pop_back();
                        int32_t seg = (int32_t)ia[pc];
                        if (in->data_dropped[seg] && n)
                            TRAPF("data segment dropped");
                        const DataSeg& ds = in->mod->data[seg];
                        if ((uint64_t)src + n > ds.bytes.size())
                            TRAPF("out of bounds memory.init");
                        if (!mem_ok(in, dst, n))
                            TRAPF("out of bounds memory access");
                        memcpy(in->mem.data() + dst, ds.bytes.data() + src, n);
                    } else if (sub == 9) {  // data.drop
                        in->data_dropped[(int32_t)ia[pc]] = 1;
                    } else if (sub == 10) {  // memory.copy
                        uint32_t n = U32(stack.back().i);
                        stack.pop_back();
                        uint32_t src = U32(stack.back().i);
                        stack.pop_back();
                        uint32_t dst = U32(stack.back().i);
                        stack.pop_back();
                        if (!mem_ok(in, src, n) || !mem_ok(in, dst, n))
                            TRAPF("out of bounds memory access");
                        memmove(in->mem.data() + dst, in->mem.data() + src, n);
                    } else if (sub == 11) {  // memory.fill
                        uint32_t n = U32(stack.back().i);
                        stack.pop_back();
                        uint8_t val = (uint8_t)(stack.back().i & 0xFF);
                        stack.pop_back();
                        uint32_t dst = U32(stack.back().i);
                        stack.pop_back();
                        if (!mem_ok(in, dst, n))
                            TRAPF("out of bounds memory access");
                        memset(in->mem.data() + dst, val, n);
                    } else {
                        TRAPF("unsupported extended op");
                    }
                } else {
                    TRAPF("unsupported opcode");
                }
        }
        pc += 1;
    }
}

}  // namespace

extern "C" {

// Every entry point that allocates is exception-guarded: C++ exceptions
// must never unwind across the ctypes boundary (undefined behavior; in
// practice std::terminate kills the whole server). Allocating void
// functions return an int32 status instead (0 ok, 1 allocation failure)
// so the bridge can raise per-request.

void* wasmint_module_new() {
    try {
        return new Module();
    } catch (...) {
        return nullptr;
    }
}

void wasmint_module_free(void* m) { delete (Module*)m; }

int32_t wasmint_add_func(void* m, int32_t type_id, int32_t n_params,
                         int32_t n_results, int32_t n_locals, int32_t is_host,
                         const uint32_t* ops, const int64_t* ia,
                         const int32_t* ib, const int32_t* ic, int64_t n) {
    try {
        Module* mod = (Module*)m;
        mod->funcs.emplace_back();
        Func& f = mod->funcs.back();
        f.type_id = type_id;
        f.n_params = n_params;
        f.n_results = n_results;
        f.n_locals = n_locals;
        f.is_host = (uint8_t)is_host;
        if (!is_host && n > 0) {
            f.ops.assign(ops, ops + n);
            f.ia.assign(ia, ia + n);
            f.ib.assign(ib, ib + n);
            f.ic.assign(ic, ic + n);
        }
        return 0;
    } catch (...) {
        return 1;
    }
}

int32_t wasmint_set_brpool(void* m, const int32_t* pool, int64_t n) {
    try {
        ((Module*)m)->br_pool.assign(pool, pool + n);
        return 0;
    } catch (...) {
        return 1;
    }
}

int32_t wasmint_add_data(void* m, const uint8_t* bytes, int64_t n) {
    try {
        Module* mod = (Module*)m;
        mod->data.emplace_back();
        mod->data.back().bytes.assign(bytes, bytes + n);
        return 0;
    } catch (...) {
        return 1;
    }
}

// C++ exceptions must not unwind across the ctypes boundary (undefined
// behavior; in practice std::terminate kills the whole server). A policy
// module can legally request a ~4 GiB initial memory, so allocation
// failure here is reachable from untrusted-but-verified input: report it
// as NULL and let the bridge raise a per-request trap instead.
void* wasmint_inst_new(void* m, int64_t mem_pages, int64_t mem_max_pages,
                       int64_t fuel, int32_t has_fuel, double deadline,
                       int32_t has_deadline, HostCb cb, void* ctx) {
    Module* mod = (Module*)m;
    Inst* in = nullptr;
    try {
        in = new Inst();
        in->mod = mod;
        in->mem.assign((size_t)(mem_pages * PAGE), 0);
        in->mem_max_pages = mem_max_pages;
        in->fuel = fuel;
        in->has_fuel = (uint8_t)has_fuel;
        in->deadline = deadline;
        in->has_deadline = (uint8_t)has_deadline;
        in->hostcb = cb;
        in->host_ctx = ctx;
        in->data_dropped.assign(mod->data.size(), 0);
        return in;
    } catch (...) {
        delete in;
        return nullptr;
    }
}

void wasmint_inst_free(void* i) { delete (Inst*)i; }

int32_t wasmint_set_globals(void* i, const uint64_t* bits, int64_t n) {
    try {
        Inst* in = (Inst*)i;
        in->globals.resize((size_t)n);
        for (int64_t k = 0; k < n; k++) memcpy(&in->globals[k], &bits[k], 8);
        return 0;
    } catch (...) {
        return 1;
    }
}

int64_t wasmint_get_global(void* i, int64_t idx) {
    Inst* in = (Inst*)i;
    int64_t out;
    memcpy(&out, &in->globals[(size_t)idx], 8);
    return out;
}

int32_t wasmint_add_table(void* i, const int32_t* elems, int64_t n) {
    try {
        Inst* in = (Inst*)i;
        in->tables.emplace_back(elems, elems + n);
        return 0;
    } catch (...) {
        return 1;
    }
}

int64_t wasmint_mem_size(void* i) {
    return (int64_t)(((Inst*)i)->mem.size());
}

int32_t wasmint_mem_read(void* i, int64_t addr, int64_t n, uint8_t* out) {
    Inst* in = (Inst*)i;
    if (addr < 0 || (uint64_t)(addr + n) > in->mem.size()) return 1;
    memcpy(out, in->mem.data() + addr, (size_t)n);
    return 0;
}

int32_t wasmint_mem_write(void* i, int64_t addr, const uint8_t* data,
                          int64_t n) {
    Inst* in = (Inst*)i;
    if (addr < 0 || (uint64_t)(addr + n) > in->mem.size()) return 1;
    memcpy(in->mem.data() + addr, data, (size_t)n);
    return 0;
}

// find the first NUL at/after addr; -1 when none (read_cstring support)
int64_t wasmint_mem_find0(void* i, int64_t addr) {
    Inst* in = (Inst*)i;
    if (addr < 0 || (uint64_t)addr >= in->mem.size()) return -1;
    const void* p = memchr(in->mem.data() + addr, 0, in->mem.size() - addr);
    if (p == nullptr) return -1;
    return (int64_t)((const uint8_t*)p - in->mem.data());
}

int64_t wasmint_fuel_left(void* i) { return ((Inst*)i)->fuel; }

void wasmint_set_fuel(void* i, int64_t fuel, int32_t has_fuel) {
    ((Inst*)i)->fuel = fuel;
    ((Inst*)i)->has_fuel = (uint8_t)has_fuel;
}

const char* wasmint_err(void* i) { return ((Inst*)i)->err; }

int32_t wasmint_invoke(void* i, int32_t findex, const uint64_t* args,
                       int32_t nargs, uint64_t* results,
                       int32_t* nresults) {
    Inst* in = (Inst*)i;
    in->err_code = OK;
    in->err[0] = 0;
    Val vargs[32];
    for (int32_t k = 0; k < nargs && k < 32; k++)
        memcpy(&vargs[k], &args[k], 8);
    Val vres[32];
    int32_t nres = 0;
    int32_t rc;
    // memory.grow and value-stack growth allocate mid-interpretation; a
    // thrown bad_alloc must become a per-request TRAP, never unwind into
    // ctypes (std::terminate would take the whole server down).
    try {
        rc = call_index(in, findex, vargs, vres, &nres);
    } catch (const std::bad_alloc&) {
        rc = trap(in, TRAP, "out of memory");
    } catch (const std::exception& e) {
        rc = trap(in, TRAP, e.what());
    } catch (...) {
        rc = trap(in, TRAP, "native engine exception");
    }
    if (rc != OK) return rc;
    for (int32_t k = 0; k < nres && k < 32; k++)
        memcpy(&results[k], &vres[k], 8);
    *nresults = nres;
    return OK;
}

}  // extern "C"
