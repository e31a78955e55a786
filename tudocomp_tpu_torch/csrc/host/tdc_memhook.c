/* tdc_memhook: LD_PRELOAD malloc interposer for byte-accurate per-phase
 * heap accounting. The port's copy of native/tdc_memhook.c: the analogue
 * of the reference's link-time malloc override
 * (src/tudocomp_stat/malloc.cpp:24-84, which tracks block sizes through a
 * magic header and feeds malloc_callback::on_alloc/on_free). Here glibc's
 * malloc_usable_size() replaces the header, and the counters are C11
 * atomics so allocations from any thread (Python, PyTorch's host
 * allocator and worker threads, the C++ host helpers) are all counted;
 * the card's memory is not malloc's and is read through torch.cuda
 * (stats/phase.py).
 *
 * Built with `g++ -x c` at first use into build/tudocomp_tpu_torch/
 * (native.memhook_so_path). Usage:
 *   TDC_MALLOC_HOOK=1 python -m tudocomp_tpu_torch --stats ...
 * (the command line re-execs itself with the library in LD_PRELOAD).
 * StatPhase reads the counters via ctypes: tdc_mem_current/tdc_mem_peak/
 * tdc_mem_reset_peak (native.memhook_counters).
 *
 * Bootstrap: dlsym(RTLD_NEXT, ...) may itself allocate (glibc calls
 * calloc), so a small static arena serves allocations made while the
 * real symbols are being resolved; frees of arena pointers are ignored.
 */
#define _GNU_SOURCE
#include <dlfcn.h>
#include <malloc.h>
#include <stdatomic.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static void* (*real_malloc)(size_t);
static void* (*real_calloc)(size_t, size_t);
static void* (*real_realloc)(void*, size_t);
static void (*real_free)(void*);
static void* (*real_memalign)(size_t, size_t);
static int (*real_posix_memalign)(void**, size_t, size_t);
static void* (*real_aligned_alloc)(size_t, size_t);
static void* (*real_valloc)(size_t);
static void* (*real_pvalloc)(size_t);
static void* (*real_reallocarray)(void*, size_t, size_t);

/* set LAST in hook_init so a concurrent caller that observes g_inited==1
 * is guaranteed to see every real_* pointer resolved (a caller observing
 * 0 re-runs the idempotent dlsym resolution itself) */
static _Atomic int g_inited = 0;

static _Atomic long long g_current = 0;
static _Atomic long long g_peak = 0;

static char boot_buf[1 << 16];
static _Atomic size_t boot_off = 0;
static volatile int initing = 0;

static int in_boot(const void* p) {
    return (const char*)p >= boot_buf && (const char*)p < boot_buf + sizeof(boot_buf);
}

static void* boot_alloc(size_t sz) {
    size_t need = (sz + 15) & ~(size_t)15;
    size_t off = atomic_fetch_add(&boot_off, need);
    if (off + need > sizeof(boot_buf)) return 0;
    return boot_buf + off;
}

static void hook_init(void) {
    if (atomic_load(&g_inited)) return;
    initing = 1;
    real_malloc = (void* (*)(size_t))dlsym(RTLD_NEXT, "malloc");
    real_calloc = (void* (*)(size_t, size_t))dlsym(RTLD_NEXT, "calloc");
    real_realloc = (void* (*)(void*, size_t))dlsym(RTLD_NEXT, "realloc");
    real_free = (void (*)(void*))dlsym(RTLD_NEXT, "free");
    real_memalign = (void* (*)(size_t, size_t))dlsym(RTLD_NEXT, "memalign");
    real_posix_memalign =
        (int (*)(void**, size_t, size_t))dlsym(RTLD_NEXT, "posix_memalign");
    real_aligned_alloc =
        (void* (*)(size_t, size_t))dlsym(RTLD_NEXT, "aligned_alloc");
    real_valloc = (void* (*)(size_t))dlsym(RTLD_NEXT, "valloc");
    real_pvalloc = (void* (*)(size_t))dlsym(RTLD_NEXT, "pvalloc");
    real_reallocarray =
        (void* (*)(void*, size_t, size_t))dlsym(RTLD_NEXT, "reallocarray");
    initing = 0;
    atomic_store(&g_inited, 1);
}

static void acct(long long d) {
    long long cur = atomic_fetch_add(&g_current, d) + d;
    long long p = atomic_load(&g_peak);
    while (cur > p &&
           !atomic_compare_exchange_weak(&g_peak, &p, cur)) {
    }
}

void* malloc(size_t sz) {
    if (!atomic_load(&g_inited)) {
        if (initing) return boot_alloc(sz);
        hook_init();
    }
    void* p = real_malloc(sz);
    if (p) acct((long long)malloc_usable_size(p));
    return p;
}

void* calloc(size_t n, size_t sz) {
    if (!atomic_load(&g_inited)) {
        if (initing) {
            void* p = boot_alloc(n * sz);
            if (p) memset(p, 0, n * sz);
            return p;
        }
        hook_init();
    }
    void* p = real_calloc(n, sz);
    if (p) acct((long long)malloc_usable_size(p));
    return p;
}

void* realloc(void* old, size_t sz) {
    if (!atomic_load(&g_inited)) hook_init();
    if (in_boot(old)) {  /* bootstrap block: treat as fresh alloc */
        void* p = real_malloc(sz);
        if (p) acct((long long)malloc_usable_size(p));
        return p;
    }
    long long before = old ? (long long)malloc_usable_size(old) : 0;
    void* p = real_realloc(old, sz);
    if (p) acct((long long)malloc_usable_size(p) - before);
    return p;
}

void free(void* p) {
    if (!p || in_boot(p)) return;
    if (!atomic_load(&g_inited)) hook_init();
    acct(-(long long)malloc_usable_size(p));
    real_free(p);
}

void* memalign(size_t align, size_t sz) {
    if (!atomic_load(&g_inited)) hook_init();
    void* p = real_memalign ? real_memalign(align, sz) : 0;
    if (p) acct((long long)malloc_usable_size(p));
    return p;
}

int posix_memalign(void** out, size_t align, size_t sz) {
    if (!atomic_load(&g_inited)) hook_init();
    int rc = real_posix_memalign ? real_posix_memalign(out, align, sz) : -1;
    if (rc == 0 && *out) acct((long long)malloc_usable_size(*out));
    return rc;
}

void* aligned_alloc(size_t align, size_t sz) {
    if (!atomic_load(&g_inited)) hook_init();
    void* p = real_aligned_alloc ? real_aligned_alloc(align, sz) : 0;
    if (p) acct((long long)malloc_usable_size(p));
    return p;
}

void* valloc(size_t sz) {
    if (!atomic_load(&g_inited)) hook_init();
    void* p = real_valloc ? real_valloc(sz) : 0;
    if (p) acct((long long)malloc_usable_size(p));
    return p;
}

void* pvalloc(size_t sz) {
    if (!atomic_load(&g_inited)) hook_init();
    void* p = real_pvalloc ? real_pvalloc(sz) : 0;
    if (p) acct((long long)malloc_usable_size(p));
    return p;
}

void* reallocarray(void* old, size_t n, size_t sz) {
    if (!atomic_load(&g_inited)) hook_init();
    if (in_boot(old)) {
        void* p = real_malloc(n * sz);
        if (p) acct((long long)malloc_usable_size(p));
        return p;
    }
    long long before = old ? (long long)malloc_usable_size(old) : 0;
    void* p = real_reallocarray ? real_reallocarray(old, n, sz) : 0;
    if (p) acct((long long)malloc_usable_size(p) - before);
    return p;
}

/* -- counter API (read via ctypes from stats/phase.py) ------------------- */

long long tdc_mem_current(void) { return atomic_load(&g_current); }
long long tdc_mem_peak(void) { return atomic_load(&g_peak); }
void tdc_mem_reset_peak(void) {
    atomic_store(&g_peak, atomic_load(&g_current));
}
int tdc_memhook_active(void) { return 1; }
