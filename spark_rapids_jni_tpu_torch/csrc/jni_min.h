// Minimal JNI compile shim.
//
// The build prefers a real <jni.h> (set JAVA_HOME); this header exists so
// the JNI bridge compiles and is unit-testable in images without a JDK.
// Types and the JNINativeInterface slot numbering follow the JNI 6 spec
// (the same table the reference's JNIEXPORT surface is loaded against);
// only the slots this bridge uses are named, the rest are reserved padding
// so the named slots sit at their specification offsets.

#ifndef SRJT_JNI_MIN_H
#define SRJT_JNI_MIN_H

#if defined(__has_include)
#if __has_include(<jni.h>)
#define SRJT_HAVE_REAL_JNI 1
#include <jni.h>
#endif
#endif

#ifndef SRJT_HAVE_REAL_JNI

#include <cstdarg>
#include <cstdint>

extern "C" {

typedef int32_t jint;
typedef int64_t jlong;
typedef int8_t jbyte;
typedef uint8_t jboolean;
typedef uint16_t jchar;
typedef int16_t jshort;
typedef float jfloat;
typedef double jdouble;
typedef jint jsize;

class _jobject {};
typedef _jobject* jobject;
typedef jobject jclass;
typedef jobject jstring;
typedef jobject jarray;
typedef jarray jobjectArray;
typedef jarray jbooleanArray;
typedef jarray jbyteArray;
typedef jarray jintArray;
typedef jarray jlongArray;
typedef jobject jthrowable;

#define JNIEXPORT __attribute__((visibility("default")))
#define JNICALL
#define JNI_TRUE 1
#define JNI_FALSE 0

struct JNINativeInterface_;
typedef const struct JNINativeInterface_* JNIEnv;

// JNI 6 function table.  Named members are at their spec slot numbers
// (comments); padding keeps the layout.
struct JNINativeInterface_ {
  void* reserved0;                                              // 0
  void* reserved1;                                              // 1
  void* reserved2;                                              // 2
  void* reserved3;                                              // 3
  void* pad4_5[2];                                              // 4-5
  jclass (*FindClass)(JNIEnv*, const char*);                    // 6
  void* pad7_13[7];                                             // 7-13
  jint (*ThrowNew)(JNIEnv*, jclass, const char*);               // 14
  jthrowable (*ExceptionOccurred)(JNIEnv*);                     // 15
  void* pad16;                                                  // 16
  void (*ExceptionClear)(JNIEnv*);                              // 17
  void* pad18_168[151];                                         // 18-168
  const char* (*GetStringUTFChars)(JNIEnv*, jstring, jboolean*);   // 169
  void (*ReleaseStringUTFChars)(JNIEnv*, jstring, const char*);    // 170
  jsize (*GetArrayLength)(JNIEnv*, jarray);                        // 171
  void* pad172;                                                    // 172
  jobject (*GetObjectArrayElement)(JNIEnv*, jobjectArray, jsize);  // 173
  void* pad174;                                                    // 174
  void* pad175_178[4];                                             // 175-178
  jintArray (*NewIntArray)(JNIEnv*, jsize);                        // 179
  jlongArray (*NewLongArray)(JNIEnv*, jsize);                      // 180
  void* pad181_182[2];                                             // 181-182
  void* pad183_198[16];                                            // 183-198
  void* pad199_202[4];                                             // 199-202
  void (*GetIntArrayRegion)(JNIEnv*, jintArray, jsize, jsize, jint*);   // 203
  void (*GetLongArrayRegion)(JNIEnv*, jlongArray, jsize, jsize, jlong*);// 204
  void* pad205_210[6];                                             // 205-210
  void (*SetIntArrayRegion)(JNIEnv*, jintArray, jsize, jsize, const jint*);   // 211
  void (*SetLongArrayRegion)(JNIEnv*, jlongArray, jsize, jsize, const jlong*);// 212
  void* pad213_228[16];                                            // 213-228
  jobject (*NewDirectByteBuffer)(JNIEnv*, void*, jlong);           // 229
  void* (*GetDirectBufferAddress)(JNIEnv*, jobject);               // 230
  jlong (*GetDirectBufferCapacity)(JNIEnv*, jobject);              // 231
  void* pad232;                                                    // 232
};

}  // extern "C"

#endif  // !SRJT_HAVE_REAL_JNI
#endif  // SRJT_JNI_MIN_H
